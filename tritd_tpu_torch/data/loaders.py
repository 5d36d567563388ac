"""Benchmark dataset ingest.

Counterpart of `tritd_tpu/data/loaders.py`. The reference drivers load
`<name>.mat` from a user-provided path (`traffic_triple_comparison.m:20`);
traffic files hold the tensor in `T`, video files in `gray_images`. Taxi is
cut to its first 500 frames (`:23-25`). When a .mat file is absent, a seeded
synthetic stand-in of the dataset's published shape is made with the
reference's recipe (`loaders.py:125-142`) from
`numpy.random.default_rng(crc32(name))`; its numbers differ from the JAX
stand-in's. Every load reports its provenance.
"""

from __future__ import annotations

import dataclasses
import os
import zlib

import numpy as np

from .synthetic import random_tritd, seasonal_cp, synthetic_video


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    kind: str                      # "traffic" | "video"
    mat_variable: str              # variable inside the .mat file
    shape: tuple[int, int, int]    # published/expected shape (synthetic fallback)
    truncate_frames: int | None = None  # taxi: keep first 500 mode-3 slices
    fctn_subdim: int = 8           # 4-way reshape factor for RC-FCTN
    sofia_period: int = 168        # SOFIA seasonal period m


DATASETS: dict[str, DatasetSpec] = {
    "sensor": DatasetSpec("sensor", "traffic", "T", (54, 4, 1440), fctn_subdim=6, sofia_period=144),
    "network": DatasetSpec("network", "traffic", "T", (23, 23, 2016), fctn_subdim=16, sofia_period=168),
    "taxi": DatasetSpec("taxi", "traffic", "T", (100, 100, 500), truncate_frames=500, fctn_subdim=10, sofia_period=7),
    "chicago": DatasetSpec("chicago", "traffic", "T", (77, 77, 2016), fctn_subdim=8, sofia_period=168),
    "highway": DatasetSpec("highway", "video", "gray_images", (240, 320, 300), fctn_subdim=20, sofia_period=1),
    "sofa": DatasetSpec("sofa", "video", "gray_images", (240, 320, 300), fctn_subdim=20, sofia_period=1),
    "office": DatasetSpec("office", "video", "gray_images", (240, 320, 300), fctn_subdim=20, sofia_period=1),
    "PETS2006": DatasetSpec("PETS2006", "video", "gray_images", (240, 320, 300), fctn_subdim=20, sofia_period=1),
}

DEFAULT_DATA_DIR = os.environ.get("TRITD_DATA_DIR", "data")


def _load_mat_variable(path: str, variable: str) -> np.ndarray:
    """Read one variable from a .mat file: scipy for <= v7, h5py for v7.3
    (HDF5 stores MATLAB's column-major arrays dim-reversed; transposed back)."""
    import scipy.io as sio

    try:
        mat = sio.loadmat(path)
    except (NotImplementedError, ValueError):
        # v7.3 (NotImplementedError) or bare HDF5 without a MAT header
        try:
            import h5py
        except ImportError as exc:
            raise ImportError(f"{path} is a v7.3 (HDF5) .mat file; reading it needs h5py") from exc
        with h5py.File(path, "r") as f:
            key = variable if variable in f else list(f.keys())[0]
            arr = np.asarray(f[key])
        return arr.transpose(tuple(reversed(range(arr.ndim))))
    if variable in mat:
        return np.asarray(mat[variable])
    candidates = [k for k in mat if not k.startswith("__")]
    if len(candidates) == 1:
        return np.asarray(mat[candidates[0]])
    raise KeyError(f"{variable} not in {path}; has {candidates}")


def save_mat73(path: str, variables: dict[str, np.ndarray]) -> str:
    """Write a MATLAB v7.3-compatible .mat: an HDF5 file with the 128-byte
    MAT header in a userblock (116 bytes of text, an 8-byte subsystem
    offset, version 0x0200, little-endian tag 'IM') and arrays stored
    dim-reversed (column-major), so scipy defers to the HDF5 reader as for a
    real `save -v7.3` file. Counterpart of `tritd_tpu/data/loaders.py:84-108`."""
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w", userblock_size=512) as f:
        for name, arr in variables.items():
            a = np.asarray(arr)
            ds = f.create_dataset(name, data=a.transpose(tuple(reversed(range(a.ndim)))))
            ds.attrs["MATLAB_class"] = np.bytes_("double")
    header = b"MATLAB 7.3 MAT-file, written by tritd_tpu_torch save_mat73"
    with open(path, "r+b") as fh:
        fh.write(header[:116].ljust(116, b"\x20"))
        fh.write(b"\x00" * 8)          # subsystem data offset
        fh.write(b"\x00\x02")          # version 0x0200 = v7.3
        fh.write(b"IM")                # little-endian indicator
    return path


def dataset_seed(name: str) -> int:
    """Deterministic per-dataset seed (crc32: stable across processes)."""
    return zlib.crc32(name.encode())


def synthetic_video_truth(spec: DatasetSpec):
    """(observed, background, fg_mask) of the port's seeded video stand-in,
    regenerated from the same draw as `synthetic_fallback`, so metric code
    can score against the stand-in's own moving-object truth. Counterpart
    of `tritd_tpu/data/loaders.py:117-122`; the JAX stand-in's draw is not
    reproducible here, so scores are taken against this port's truth."""
    return synthetic_video(np.random.default_rng(dataset_seed(spec.name)), spec.shape)


def synthetic_traffic(spec: DatasetSpec, rng: np.random.Generator) -> np.ndarray:
    """Mixed-family traffic stand-in: unit-RMS low-TriTD-rank + 0.8x unit-RMS
    seasonal low-CP (period = the dataset's SOFIA preset) + 10% relative
    noise, scaled to an O(100) dynamic range."""
    x_tritd, _ = random_tritd(rng, spec.shape, rank=5, dtype=np.float32)
    x_cp = seasonal_cp(rng, spec.shape, rank=3, period=spec.sofia_period)
    x = x_tritd.astype(np.float64) + 0.8 * x_cp
    noise = rng.standard_normal(x.shape)
    x = x + 0.1 * np.linalg.norm(x) / np.linalg.norm(noise) * noise
    return 50.0 * x


def synthetic_fallback(spec: DatasetSpec) -> np.ndarray:
    """Seeded stand-in of the dataset's shape, float64."""
    rng = np.random.default_rng(dataset_seed(spec.name))
    if spec.kind == "video":
        x, _bg, _fg = synthetic_video(rng, spec.shape)
    else:
        x = synthetic_traffic(spec, rng)
    return x.astype(np.float64)


def load_dataset(
    name: str, data_dir: str | None = None
) -> tuple[np.ndarray, DatasetSpec, str]:
    """Returns (tensor float64, spec, provenance) with provenance in
    {"mat", "synthetic"}, after the driver's preprocessing (double cast,
    taxi truncation)."""
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(DATASETS)}")
    spec = DATASETS[name]
    path = os.path.join(data_dir or DEFAULT_DATA_DIR, f"{name}.mat")
    if os.path.exists(path):
        x = _load_mat_variable(path, spec.mat_variable).astype(np.float64)
        provenance = "mat"
    else:
        x = synthetic_fallback(spec)
        provenance = "synthetic"
    if spec.truncate_frames is not None and x.shape[-1] > spec.truncate_frames:
        x = x[..., : spec.truncate_frames]
    return x, spec, provenance


def load_groundtruth(name: str, data_dir: str | None = None) -> np.ndarray | None:
    """CDnet ground-truth label frames (`<name>_gt.mat`, variable
    `groundtruth`, labels 0/170/255) if present, else None. Counterpart of
    `tritd_tpu/data/loaders.py:182-191`."""
    path = os.path.join(data_dir or DEFAULT_DATA_DIR, f"{name}_gt.mat")
    if not os.path.exists(path):
        return None
    return _load_mat_variable(path, "groundtruth")
