"""TriTD-ALS and TriTD-MALS: alternating ridge least squares on an
uncorrupted tensor (no sparse part).

PyTorch counterpart of `tritd_tpu/solvers/als.py` (reference:
`fast_robust_triple_tensor/triple_decomp_ALS.m:1-64`). ALS records the
relative error of the CURRENT factors first, checks the relative-change
stop, then does the three mode solves with a fixed 1e-9 ridge (`cfg.alpha_c`).

MALS (`triple_decomp_MALS.m`) is broken as committed; as in the reference
package, this is the repaired intent: the same mode updates, the error
recorded AFTER the sweep, and no early stop (always max_iter iterations).
"""

from __future__ import annotations

import torch

from .. import interop
from ..ops import designs, normal_eq
from ..ops.fold import core_a_from_mat, core_b_from_mat, core_c_from_mat
from ..ops.kruskal import solver_input
from .admm import init_factors
from .base import TriTDConfig, TriTDResult


def _als_sweep(x, a, b, c, cfg: TriTDConfig):
    """Three ridge mode solves with alpha = cfg.alpha_c
    (`triple_decomp_ALS.m:25-38`)."""
    r, variant, method, alpha = cfg.rank, cfg.variant, cfg.solve_method, cfg.alpha_c
    k1, rhs1 = normal_eq.gram_and_rhs(1, x, a, b, c, variant=variant)
    a = core_a_from_mat(normal_eq.ridge_solve(k1, rhs1, alpha, method), r)
    k2, rhs2 = normal_eq.gram_and_rhs(2, x, a, b, c, variant=variant)
    b = core_b_from_mat(normal_eq.ridge_solve(k2, rhs2, alpha, method), r)
    k3, rhs3 = normal_eq.gram_and_rhs(3, x, a, b, c, variant=variant)
    c = core_c_from_mat(normal_eq.ridge_solve(k3, rhs3, alpha, method), r)
    return a, b, c


def _als_run(x, cfg: TriTDConfig, mals: bool, init, generator, device) -> TriTDResult:
    dtype = cfg.torch_dtype()
    x = solver_input(x, dtype, device)
    norm_x = torch.linalg.vector_norm(x)
    if init is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init = init_factors(generator, tuple(x.shape), cfg.rank, dtype, x.device)
    a, b, c = interop.factors_from_numpy(*init, device=x.device, dtype=dtype)
    err_hist = torch.full((cfg.max_iter,), float("nan"), dtype=dtype, device=x.device)

    def rel_err(a, b, c):
        xhat = designs.triple_product(a, b, c, variant=cfg.variant)
        return torch.linalg.vector_norm(x - xhat) / norm_x

    k = 0
    done = False
    while k < cfg.max_iter and not done:
        if mals:
            # sweep first, then record the post-sweep error; no stop
            a, b, c = _als_sweep(x, a, b, c, cfg)
            err_hist[k] = rel_err(a, b, c)
        else:
            # record the incoming factors' error, stop on relative change,
            # then sweep (`triple_decomp_ALS.m:16-38`)
            err = rel_err(a, b, c)
            err_hist[k] = err
            if k >= 1:
                err_prev = err_hist[k - 1]
                done = bool(torch.abs(err - err_prev) < cfg.tol * err_prev)
            a, b, c = _als_sweep(x, a, b, c, cfg)
        k += 1
    zeros = torch.zeros_like(x)
    return TriTDResult(a=a, b=b, c=c, o=zeros, e=zeros,
                       err_hist=err_hist, rre_hist=err_hist, n_iters=k)


def tritd_als(x, cfg: TriTDConfig = TriTDConfig(tol=1e-5), init=None,
              generator: torch.Generator | None = None, device=None) -> TriTDResult:
    """Alternating-LS TriTD fit of an uncorrupted tensor, on the device of `x`
    (`device` as for `tritd_admm`)."""
    return _als_run(x, cfg, False, init, generator, device)


def tritd_mals(x, cfg: TriTDConfig = TriTDConfig(), init=None,
               generator: torch.Generator | None = None, device=None) -> TriTDResult:
    """Repaired MALS variant (see module docstring); `device` as for
    `tritd_admm`."""
    return _als_run(x, cfg, True, init, generator, device)
