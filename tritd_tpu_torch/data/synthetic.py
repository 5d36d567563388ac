"""Synthetic fixtures: low-TriTD-rank tensors, sparse outliers, missing masks.

Counterpart of `tritd_tpu/data/synthetic.py`, drawn with a
`numpy.random.Generator` (`numpy.random.default_rng(seed)`) instead of
`jax.random`. The recipes and shapes are the reference's; the numbers are
not, so a stand-in made here is not the JAX stand-in of the same seed.
Arrays are returned as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.designs import triple_product


def random_tritd(
    rng: np.random.Generator,
    shape: tuple[int, int, int],
    rank: int,
    variant: str = "hadamard",
    dtype=np.float32,
    scale: float = 1.0,
):
    """Ground-truth low-TriTD-rank tensor from standard-normal cores,
    normalized so entries are O(1). Returns (tensor, (a, b, c))."""
    n1, n2, n3 = shape
    a = rng.standard_normal((n1, rank, rank)).astype(dtype)
    b = rng.standard_normal((rank, n2, rank)).astype(dtype)
    c = rng.standard_normal((rank, rank, n3)).astype(dtype)
    x = triple_product(*map(torch.from_numpy, (a, b, c)), variant=variant).numpy()
    x = scale * x / (np.sqrt(np.mean(x**2)) + 1e-12)
    return x.astype(dtype), (a, b, c)


def seasonal_cp(
    rng: np.random.Generator,
    shape: tuple[int, int, int],
    rank: int = 3,
    period: int = 168,
    dtype=np.float32,
) -> np.ndarray:
    """Low-CP tensor with seasonal temporal factors (SOFIA's generative
    family, `make_synthetic.m:11-27`): standard-normal spatial factors,
    temporal factor r a sinusoid at harmonic r of `period` with random phase
    plus a slow linear trend. Normalized to unit RMS."""
    n1, n2, n3 = shape
    a = rng.standard_normal((n1, rank))
    b = rng.standard_normal((n2, rank))
    t = np.arange(n3, dtype=np.float64)
    phase = rng.uniform(0.0, 2.0 * np.pi, rank)
    harm = np.arange(1, rank + 1, dtype=np.float64)
    c = np.sin(2.0 * np.pi * harm[None, :] * t[:, None] / period + phase)
    trend = rng.standard_normal(rank) * (t[:, None] / n3)
    ab = (a[:, None, :] * b[None, :, :]).reshape(n1 * n2, rank)
    x = (ab @ (c + 0.3 * trend).T).reshape(n1, n2, n3)
    return (x / (np.sqrt(np.mean(x**2)) + 1e-12)).astype(dtype)


def sparse_outliers(
    rng: np.random.Generator,
    shape: tuple[int, ...],
    density: float,
    magnitude: float = 10.0,
    dtype=np.float32,
) -> np.ndarray:
    """Bernoulli(density) +/- magnitude spikes (SOFIA `make_outlier.m`)."""
    hit = rng.random(shape) < density
    sign = np.where(rng.random(shape) < 0.5, 1.0, -1.0)
    return (hit * sign * magnitude).astype(dtype)


def uniform_missing_mask(
    rng: np.random.Generator, shape: tuple[int, ...], missing_ratio: float
) -> np.ndarray:
    """Boolean OBSERVED mask with exactly round(ratio * numel) missing
    entries drawn uniformly without replacement — the driver's protocol
    (`traffic_triple_comparison.m:27-32`, randperm). True = observed."""
    total = int(np.prod(shape))
    num_missing = int(round(missing_ratio * total))
    missing = np.zeros(total, bool)
    missing[rng.permutation(total)[:num_missing]] = True
    return ~missing.reshape(shape)


def synthetic_video(
    rng: np.random.Generator,
    shape: tuple[int, int, int],
    rank: int = 5,
    bg_low: float = 40.0,
    bg_high: float = 215.0,
    fg_magnitude: float = 80.0,
    dtype=np.float32,
):
    """CDnet-like stand-in: a low-TriTD-rank background mapped affinely into
    [bg_low, bg_high] (an affine map keeps the low-rank structure) plus an
    (n1/8 x n2/8) bright block whose corner moves linearly with wraparound.
    Returns (observed, background, fg_mask)."""
    n1, n2, n3 = shape
    x, _ = random_tritd(rng, shape, rank, dtype=dtype)
    lo, hi = x.min(), x.max()
    bg = bg_low + (bg_high - bg_low) * (x - lo) / (hi - lo + 1e-9)

    h, w = max(n1 // 8, 1), max(n2 // 8, 1)
    t_idx = np.arange(n3)
    r0 = (t_idx * 3) % max(n1 - h, 1)
    c0 = (t_idx * 5) % max(n2 - w, 1)
    rows = np.arange(n1)[:, None, None]
    cols = np.arange(n2)[None, :, None]
    fg_mask = (
        (rows >= r0[None, None, :]) & (rows < (r0 + h)[None, None, :])
        & (cols >= c0[None, None, :]) & (cols < (c0 + w)[None, None, :])
    )
    observed = (bg + fg_magnitude * fg_mask).astype(dtype)
    return observed, bg.astype(dtype), fg_mask


def make_completion_problem(
    rng: np.random.Generator,
    shape: tuple[int, int, int] = (30, 30, 40),
    rank: int = 3,
    missing_ratio: float = 0.1,
    outlier_density: float = 0.0,
    outlier_magnitude: float = 10.0,
    noise_std: float = 0.0,
    variant: str = "hadamard",
    dtype=np.float32,
):
    """End-to-end synthetic problem mirroring the driver protocol
    (`traffic_triple_comparison.m:27-35`): clean low-TriTD-rank X, optional
    sparse corruption and Gaussian noise, a uniform missing mask and the
    zero-filled observation Y. Counterpart of
    `tritd_tpu/data/synthetic.py:140`.

    Returns a dict with x (truth), y (observed, zero-filled), mask
    (observed), outliers and the generating cores, as numpy."""
    x, cores = random_tritd(rng, shape, rank, variant=variant, dtype=dtype)
    o = (
        sparse_outliers(rng, shape, outlier_density, outlier_magnitude, dtype)
        if outlier_density > 0
        else np.zeros(shape, dtype)
    )
    noise = noise_std * rng.standard_normal(shape).astype(dtype) if noise_std > 0 else 0.0
    mask = uniform_missing_mask(rng, shape, missing_ratio)
    y = np.where(mask, x + o + noise, 0.0).astype(dtype)
    return {"x": x, "y": y, "mask": mask, "outliers": o, "cores": cores}
