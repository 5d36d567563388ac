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
and the reference runs them through XLA. On the card the loop runs as the
reference's `lax.while_loop` does (`tritd_tpu/solvers/outlier.py:60-118`):
the counter and the stop flag on the card, the stop rule computed there,
O and the two duals taking turns in two sets of buffers, one iteration a
replay of a CUDA graph after the first (`admm._DeviceLoop`); the host
reads the flag after each replay. The host loop, which reads the flag
after every iteration too, is the route of the CPU and of the solve
methods "pinv" and "lstsq" (`admm.UNCAPTURED_METHODS`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import interop
from ..ops import designs, normal_eq
from ..ops.fold import core_a_from_mat, core_b_from_mat, core_c_from_mat
from ..ops.kruskal import solver_input
from ..ops.shrinkage import lp_reweight, weighted_soft_threshold
from . import admm
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
    device=None,
) -> TriTDResult:
    """Nonconvex reweighted robust TriTD on the device of `x` (see module
    docstring). `init`/`generator`/`device` as for `tritd_admm`."""
    x = solver_input(x, cfg.torch_dtype(), device)
    return _outlier_run(x, cfg, init, generator,
                        graphs=True if admm._graph_route(x.device, method=cfg.solve_method) else None)


def _outlier_iteration(x, a, b, c, o, lam_dual, gam_dual, cfg: OutlierConfig, ones, out=None):
    """One iteration (`test.m:36-118`) from the factors and the data-sized
    O and duals: the next factors, O, duals and the residual x - Y - O.
    `out` = (o, lam_dual, gam_dual) tensors to store the next data-sized
    values into, none of them an input."""
    o_out, lam_out, gam_out = out if out is not None else (None, None, None)
    r, rho, variant, method = cfg.rank, cfg.rho, cfg.variant, cfg.solve_method
    # Y update from the current triple product (`test.m:36-38`)
    t = designs.triple_product(a, b, c, variant=variant)
    y_new = (x - o + rho * (t + lam_dual / rho)) / (1.0 + rho)
    # O update: weighted soft threshold with W_O = 1 (`test.m:42-44`)
    o = weighted_soft_threshold(x - y_new + gam_dual / rho, cfg.lambda_l1 / rho, ones, out=o_out)
    # dual ascent (`test.m:47-48`)
    lam_dual = torch.add(lam_dual, rho * (t - y_new), out=lam_out)
    gam_dual = torch.add(gam_dual, rho * (x - y_new - o), out=gam_out)
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
    # contiguous factors on both routes: the device form carries them in
    # contiguous buffers, and GEMMs may round otherwise on other layouts
    return a.contiguous(), b.contiguous(), c.contiguous(), o, lam_dual, gam_dual, x - y_new - o


def _outlier_run(x, cfg: OutlierConfig, init, generator, graphs: bool | None) -> TriTDResult:
    """The solve of `x` (a tensor in cfg.dtype): with `graphs` None the host
    loop, which reads the stop flag after every iteration, else the device
    form (`admm._DeviceLoop`), its blocks replayed as CUDA graphs when
    `graphs` is True."""
    dtype = cfg.torch_dtype()
    norm_x = torch.linalg.vector_norm(x)
    if init is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init = init_factors(generator, tuple(x.shape), cfg.rank, dtype, x.device)
    a, b, c = interop.factors_from_numpy(*init, device=x.device, dtype=dtype)
    zeros = torch.zeros_like(x)
    err_hist = torch.full((cfg.max_iter,), float("nan"), dtype=dtype, device=x.device)
    ones = torch.ones_like(x)

    if graphs is None:
        o, lam_dual, gam_dual = zeros, zeros, zeros
        k = 0
        done = False
        while k < cfg.max_iter and not done:
            a, b, c, o, lam_dual, gam_dual, res = _outlier_iteration(x, a, b, c, o, lam_dual, gam_dual, cfg, ones)
            err = torch.linalg.vector_norm(res) / norm_x
            err_hist[k] = err
            done = bool(admm._relative_change_stop(err_hist, k, err, cfg.tol))
            k += 1
        return TriTDResult(a=a, b=b, c=c, o=o, e=o, err_hist=err_hist, rre_hist=err_hist, n_iters=k)

    def iteration(carry, data, out):
        a, b, c, o, _lam, _gam, res = _outlier_iteration(x, carry["a"], carry["b"], carry["c"], *data, cfg, ones,
                                                         out=out)
        k = carry["k"]
        err = torch.linalg.vector_norm(res) / norm_x
        admm._write(err_hist, k, err)
        return dict(a=a, b=b, c=c, k=k + 1, done=admm._relative_change_stop(err_hist, k, err, cfg.tol))

    carry = dict(a=a.clone(), b=b.clone(), c=c.clone(), k=torch.zeros((), dtype=torch.int64, device=x.device),
                 done=torch.zeros((), dtype=torch.bool, device=x.device))
    loop = admm._DeviceLoop(iteration, carry, (zeros, zeros, zeros), cfg.max_iter, x.device, graphs)
    carry, (o, _lam, _gam) = loop.advance(cfg.max_iter)
    return TriTDResult(a=carry["a"], b=carry["b"], c=carry["c"], o=o, e=o, err_hist=err_hist, rre_hist=err_hist,
                       n_iters=loop.k)
