"""Distances between what a timed solve produced and the plain reference's."""

from __future__ import annotations

import torch


def relative_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / max(||ref||, ||got||) in float64: 0 where both are
    zero (an l1 clone still all shrunk away), inf where got is not finite."""
    got, ref = got.to(torch.float64), ref.to(torch.float64)
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    scale = max(float(torch.linalg.vector_norm(ref)), float(torch.linalg.vector_norm(got)))
    return float(torch.linalg.vector_norm(got - ref)) / scale if scale > 0 else 0.0
