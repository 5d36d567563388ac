"""Datasets: synthetic stand-ins and .mat ingest. Counterpart of `tritd_tpu/data/`."""

from .loaders import DATASETS, DatasetSpec, load_dataset
from .synthetic import random_tritd, sparse_outliers, synthetic_video, uniform_missing_mask

__all__ = [
    "DATASETS",
    "DatasetSpec",
    "load_dataset",
    "random_tritd",
    "sparse_outliers",
    "synthetic_video",
    "uniform_missing_mask",
]
