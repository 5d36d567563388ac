"""The reference's two MEX proximal operators as vectorized tensor code.

PyTorch counterpart of `tritd_tpu/ops/prox.py`. The only native code in the
reference lives in the TT-TRPCA vendored repo's proximal-operator library:

  * `cappedsimplexprojection.cpp:1-185`: Euclidean projection onto the
    capped simplex {x : 0 <= x <= 1, sum x = s} (used by project_fantope.m).
  * `flsa.c` / `flsa.h`: Fused Lasso Signal Approximator
    min_x 0.5||x - v||^2 + lam1 ||x||_1 + lam2 ||D x||_1 via SFA on the dual.

Here the simplex projection is a monotone-threshold bisection and FLSA is
FISTA on the box-constrained TV dual followed by l1 shrinkage: fixed-trip
loops of whole-vector operations, on the device of the input. The exact
sequential C++ counterparts live in :mod:`tritd_tpu_torch.runtime.native`.
"""

from __future__ import annotations

import torch

from .kruskal import on_input_device
from .shrinkage import soft_threshold


@on_input_device("v")
def capped_simplex_projection(v: torch.Tensor, s, iters: int = 64) -> torch.Tensor:
    """Project v onto {x : 0 <= x <= 1, sum(x) = s}.

    The KKT solution is x = clip(v - tau, 0, 1) with tau chosen so the sum
    constraint holds; phi(tau) = sum clip(v - tau, 0, 1) is monotone
    decreasing, so tau is found by bisection (64 iterations reach machine
    precision), with no host read inside the loop."""
    s = torch.as_tensor(s, dtype=v.dtype, device=v.device)
    lo = torch.min(v) - 1.0
    hi = torch.max(v)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_big = torch.sum(torch.clamp(v - mid, 0.0, 1.0)) > s
        lo, hi = torch.where(too_big, mid, lo), torch.where(too_big, hi, mid)
    tau = 0.5 * (lo + hi)
    return torch.clamp(v - tau, 0.0, 1.0)


@on_input_device("v")
def flsa(v: torch.Tensor, lam1, lam2, iters: int = 200) -> torch.Tensor:
    """Fused Lasso Signal Approximator on a 1-D signal.

    min_x 0.5||x - v||^2 + lam1||x||_1 + lam2 * sum_i |x[i+1] - x[i]|

    Decomposes (classically) as soft_threshold(tv_prox(v, lam2), lam1).
    The TV prox solves the dual max_{||z||_inf <= lam2} -0.5||v - D^T z||^2
    by FISTA with step 1/4 (||D D^T|| <= 4)."""
    n = v.shape[0]
    lam2 = torch.as_tensor(lam2, dtype=v.dtype, device=v.device)

    def dt(z):  # D^T z, D the forward-difference operator (n-1, n)
        return torch.cat([-z[:1], z[:-1] - z[1:], z[-1:]])

    def d(x):  # D x
        return x[1:] - x[:-1]

    z = y = torch.zeros((n - 1,), dtype=v.dtype, device=v.device)
    # t follows a data-free recurrence: kept on the host in the dtype of v
    t = torch.ones((), dtype=v.dtype)
    for _ in range(iters):
        grad = d(dt(y) - v)
        z_new = torch.clamp(y - 0.25 * grad, -lam2, lam2)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        y = z_new + float((t - 1.0) / t_new) * (z_new - z)
        z, t = z_new, t_new
    return soft_threshold(v - dt(z), lam1)
