"""Elementwise proximal/shrinkage operators.

PyTorch counterpart of `tritd_tpu/ops/shrinkage.py`. Reference counterparts:
  * `fast_robust_triple_tensor/soft_threshold.m:1-2`
  * weighted variant `fast_robust_triple_tensor/test.m:96-101`
  * `other_methods/IPI_RTC_FCTN-main/lib/prox_l1.m:12`
  * SOFIA `thres_soft.m`, `huber.m` (k=2 clip), `biweight.m`
"""

from __future__ import annotations

import torch

from .kruskal import on_input_device


@on_input_device("x")
def soft_threshold(x: torch.Tensor, lam) -> torch.Tensor:
    """sign(x) * max(|x| - lam, 0). NaN propagates, as in jnp.maximum."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - lam, min=0.0)


@on_input_device("x", "w")
def weighted_soft_threshold(x: torch.Tensor, tau, w: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """sign(x) * max(|x| - tau * w, 0) — per-element thresholds
    (`fast_robust_triple_tensor/test.m:77-101`); stored into `out` when
    given (a solve loop's buffer)."""
    return torch.mul(torch.sign(x), torch.clamp(torch.abs(x) - tau * w, min=0.0), out=out)


@on_input_device("x")
def lp_reweight(x: torch.Tensor, epsilon: float, p: float, theta: float) -> torch.Tensor:
    """W = 1 / (|x| + epsilon)^(theta - p), the l_p-style reweighting of the
    nonconvex variant (`fast_robust_triple_tensor/test.m:86`)."""
    return 1.0 / torch.pow(torch.abs(x) + epsilon, theta - p)


@on_input_device("b")
def prox_l1(b: torch.Tensor, lam) -> torch.Tensor:
    """Proximal operator of lam*||.||_1 in the max/min form of `prox_l1.m:12`
    (equal to :func:`soft_threshold`)."""
    return torch.clamp(b - lam, min=0.0) + torch.clamp(b + lam, max=0.0)


@on_input_device("x")
def huber_clip(x: torch.Tensor, k: float = 2.0) -> torch.Tensor:
    """Huber psi-function clip to [-k, k] (SOFIA `huber.m`)."""
    return torch.clamp(x, -k, k)


@on_input_device("x")
def biweight(x: torch.Tensor, k: float = 4.685) -> torch.Tensor:
    """Tukey biweight psi-function (SOFIA `biweight.m`)."""
    inside = torch.abs(x) <= k
    return torch.where(inside, x * (1.0 - (x / k) ** 2) ** 2, torch.zeros_like(x))
