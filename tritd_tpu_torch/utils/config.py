"""Experiment presets — the hard-coded constants of the two driver scripts.

PyTorch counterpart of `tritd_tpu/utils/config.py` (TriTD presets and
protocol constants; the baseline presets are not ported yet).

Completion preset: `traffic_triple_comparison.m:42-51`
Video preset:      `video_triple_comparison.m:41-49`
"""

from __future__ import annotations

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
