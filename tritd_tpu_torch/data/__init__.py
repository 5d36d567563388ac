"""Datasets: synthetic stand-ins and .mat ingest. Counterpart of `tritd_tpu/data/`."""

from .loaders import (
    DATASETS,
    DatasetSpec,
    load_dataset,
    load_groundtruth,
    save_mat73,
    synthetic_video_truth,
)
from .synthetic import (
    make_completion_problem,
    random_tritd,
    sparse_outliers,
    synthetic_video,
    uniform_missing_mask,
)

__all__ = [
    "DATASETS",
    "DatasetSpec",
    "load_dataset",
    "load_groundtruth",
    "save_mat73",
    "synthetic_video_truth",
    "make_completion_problem",
    "random_tritd",
    "sparse_outliers",
    "synthetic_video",
    "uniform_missing_mask",
]
