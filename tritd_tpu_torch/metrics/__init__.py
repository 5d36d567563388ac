"""Evaluation layer: reconstruction, image quality, foreground
segmentation. Counterpart of `tritd_tpu/metrics/`."""

from .recon import evaluate, relative_change, rre
from .image import msam, msiqa, psnr, quality, ssim_frame
from .foreground import (
    ForegroundScores,
    average_precision,
    foreground_scores,
    graythresh_matlab_double,
    mean_average_precision,
    predict_masks,
)

__all__ = [
    "evaluate",
    "rre",
    "relative_change",
    "psnr",
    "ssim_frame",
    "quality",
    "msam",
    "msiqa",
    "ForegroundScores",
    "foreground_scores",
    "predict_masks",
    "graythresh_matlab_double",
    "average_precision",
    "mean_average_precision",
]
