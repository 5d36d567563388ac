"""Nonconvex-robust TriTD-ADMM variant with l_p-style reweighted shrinkage.

PyTorch counterpart of `tritd_tpu/solvers/outlier.py` (reference:
`fast_robust_triple_tensor/test.m:1-211`, which declares
`triple_decomp_ADMM_outlier`). Single-penalty ADMM on the splitting
Y = TriTD(A,B,C), X = Y + O, with

  * weighted soft-thresholding of O (weights = 1, `test.m:42-44`),
  * a weighted soft-threshold of the freshly solved A rows with weights
    W_A = 1/(|A| + eps)^(theta - p) (`test.m:77-93`),
  * factor solves on the RAW data X, with ridge 1e-12 for A and 1e-9 for
    B and C (`test.m:80,109,116`).

Its elementwise steps are plain PyTorch: they are not the fused ADMM block,
and the reference runs them through XLA. The loop is a host loop that
reads the stop flag after every iteration, as the reference's while_loop
tests it every iteration.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import interop
from ..ops import designs, normal_eq
from ..ops.fold import core_a_from_mat, core_b_from_mat, core_c_from_mat
from ..ops.shrinkage import lp_reweight, weighted_soft_threshold
from .admm import init_factors
from .base import TriTDResult


@dataclasses.dataclass(frozen=True)
class OutlierConfig:
    """Arguments of `triple_decomp_ADMM_outlier(X, r, rho, lambda, gamma_A,
    epsilon, p, theta, maxIter, tol)` (`test.m:1`)."""

    rank: int = 5
    rho: float = 1.0
    lambda_l1: float = 0.1
    gamma_a: float = 1e-3
    epsilon: float = 1e-3
    p: float = 0.5
    theta: float = 1.0
    max_iter: int = 100
    tol: float = 1e-5
    variant: str = "hadamard"
    solve_method: str = "cholesky"
    dtype: str = "float32"

    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)


def tritd_admm_outlier(
    x,
    cfg: OutlierConfig = OutlierConfig(),
    init=None,
    generator: torch.Generator | None = None,
) -> TriTDResult:
    """Nonconvex reweighted robust TriTD on the device of `x` (see module
    docstring). `init`/`generator` as for `tritd_admm`."""
    dtype = cfg.torch_dtype()
    x = torch.as_tensor(x).to(dtype)
    norm_x = torch.linalg.vector_norm(x)
    if init is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init = init_factors(generator, tuple(x.shape), cfg.rank, dtype)
    a, b, c = interop.factors_from_numpy(*init, device=x.device, dtype=dtype)
    o = torch.zeros_like(x)
    lam_dual = torch.zeros_like(x)
    gam_dual = torch.zeros_like(x)
    err_hist = torch.full((cfg.max_iter,), float("nan"), dtype=dtype, device=x.device)
    r, rho, variant, method = cfg.rank, cfg.rho, cfg.variant, cfg.solve_method
    ones = torch.ones_like(x)
    k = 0
    done = False
    while k < cfg.max_iter and not done:
        # Y update from the current triple product (`test.m:36-38`)
        t = designs.triple_product(a, b, c, variant=variant)
        y_new = (x - o + rho * (t + lam_dual / rho)) / (1.0 + rho)
        # O update: weighted soft threshold with W_O = 1 (`test.m:42-44`)
        o = weighted_soft_threshold(x - y_new + gam_dual / rho, cfg.lambda_l1 / rho, ones)
        # dual ascent (`test.m:47-48`)
        lam_dual = lam_dual + rho * (t - y_new)
        gam_dual = gam_dual + rho * (x - y_new - o)
        # A solve on RAW data + nonconvex reweighted shrinkage (`test.m:73-93`)
        k1, rhs1 = normal_eq.gram_and_rhs(1, x, a, b, c, variant=variant)
        a_rows = normal_eq.ridge_solve(k1, rhs1, 1e-12, method)
        w_a = lp_reweight(a_rows, cfg.epsilon, cfg.p, cfg.theta)
        a = core_a_from_mat(weighted_soft_threshold(a_rows, cfg.gamma_a, w_a), r)
        # B, C solves on raw data with 1e-9 ridge (`test.m:105-118`)
        k2, rhs2 = normal_eq.gram_and_rhs(2, x, a, b, c, variant=variant)
        b = core_b_from_mat(normal_eq.ridge_solve(k2, rhs2, 1e-9, method), r)
        k3, rhs3 = normal_eq.gram_and_rhs(3, x, a, b, c, variant=variant)
        c = core_c_from_mat(normal_eq.ridge_solve(k3, rhs3, 1e-9, method), r)

        err = torch.linalg.vector_norm(x - y_new - o) / norm_x
        err_hist[k] = err
        if k >= 1:
            err_prev = err_hist[k - 1]
            done = bool(torch.abs(err - err_prev) < cfg.tol * err_prev)
        k += 1
    return TriTDResult(a=a, b=b, c=c, o=o, e=o, err_hist=err_hist, rre_hist=err_hist, n_iters=k)
