"""Elementwise shrinkage. PyTorch counterpart of `soft_threshold` in
`tritd_tpu/ops/shrinkage.py` (reference:
`fast_robust_triple_tensor/soft_threshold.m:1-2`)."""

from __future__ import annotations

import torch


def soft_threshold(x: torch.Tensor, lam) -> torch.Tensor:
    """sign(x) * max(|x| - lam, 0). NaN propagates, as in jnp.maximum."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - lam, min=0.0)
