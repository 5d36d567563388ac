"""Experiment presets — the hard-coded constants of the two driver scripts.

PyTorch counterpart of `tritd_tpu/utils/config.py`.

Completion preset: `traffic_triple_comparison.m:42-51`
Video preset:      `video_triple_comparison.m:41-49`
Baseline presets:  TTNN `traffic_triple_comparison.m:116-120`,
                   RING `:139`, FCTN `:155-168`, SOFIA `:79-96`;
                   video RING `video_triple_comparison.m:156`,
                   FCTN `:246-258`.
"""

from __future__ import annotations

import dataclasses

from ..solvers.base import TriTDConfig

COMPLETION_TRITD = TriTDConfig(
    rank=5, max_iter=100, tol=1e-5,
    mu=1e-3, rho=1.25, lambda_l1=1.8, lambda2=1e-3,
)

VIDEO_TRITD = TriTDConfig(
    rank=5, max_iter=100, tol=1e-5,
    mu=1e-2, rho=1.2, lambda_l1=1.8, lambda2=1e-2,
)

COMPLETION_MISSING_RATIO = 0.15  # driver as committed (`traffic...m:5`);
                                 # README's table protocol is 0.10
README_MISSING_RATIO = 0.10
VIDEO_MISSING_RATIO = 0.0

COMPLETION_DATASETS = ("sensor", "network", "taxi", "chicago")
VIDEO_DATASETS = ("PETS2006", "sofa", "highway", "office")


@dataclasses.dataclass(frozen=True)
class TTNNPreset:
    lam: float = 50.0
    f: float = 5.0
    gamma: float = 0.001
    deta: float = 0.002
    max_iter: int = 100


@dataclasses.dataclass(frozen=True)
class RingPreset:
    mu_completion: float = 1e-1   # traffic driver (`:139`)
    mu_video: float = 1e-3        # video driver (`:156`)
    max_iter: int = 100


@dataclasses.dataclass(frozen=True)
class FCTNPreset:
    # traffic: lambda = 5000/sqrt(max(n1,n2)*n3*n4), f=0.1, tol 1e-6 (`:155-168`)
    lamb_scale: float = 5000.0
    gamma: float = 1e-3
    deta: float = 1e-3
    f: float = 0.1
    tol: float = 1e-6
    max_iter: int = 100
    # video: fixed lambda=1.8, f=0.7, tol 1e-4 (`video...m:246-258`)
    video_lambda: float = 1.8
    video_f: float = 0.7
    video_tol: float = 1e-4


@dataclasses.dataclass(frozen=True)
class SofiaPreset:
    rank: int = 3
    lambda1: float = 0.1
    lambda2: float = 0.001
    lambda3: float = 10.0
    max_epoch: int = 100
    tol: float = 1e-5


TTNN_PRESET = TTNNPreset()
RING_PRESET = RingPreset()
FCTN_PRESET = FCTNPreset()
SOFIA_PRESET = SofiaPreset()
