"""Result-artifact store mirroring the reference's .mat naming scheme.

Counterpart of `tritd_tpu/utils/artifacts.py`: the drivers save
`<dataset>_<method>_{errHist,Xhat,O}.mat` and `<name>_raw.mat`
(`video_triple_comparison.m:58-62,32`; `traffic_triple_comparison.m:58-60`);
the same stems are kept with .npz, so both packages write interchangeable
files.
"""

from __future__ import annotations

import os

import numpy as np


def artifact_path(out_dir: str, dataset: str, method: str, what: str) -> str:
    return os.path.join(out_dir, f"{dataset}_{method}_{what}.npz")


def save_artifact(out_dir: str, dataset: str, method: str, what: str, value) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = artifact_path(out_dir, dataset, method, what)
    np.savez_compressed(path, **{what: np.asarray(value)})
    return path


def load_artifact(out_dir: str, dataset: str, method: str, what: str) -> np.ndarray:
    with np.load(artifact_path(out_dir, dataset, method, what)) as f:
        return f[what]


def save_raw(out_dir: str, dataset: str, y) -> str:
    """`save(sprintf("%s_raw.mat", name), 'Y')` equivalent: `<dataset>_raw.npz`
    holding `Y`."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{dataset}_raw.npz")
    np.savez_compressed(path, Y=np.asarray(y))
    return path
