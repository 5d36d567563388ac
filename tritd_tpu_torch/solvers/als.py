"""TriTD-ALS and TriTD-MALS: alternating ridge least squares on an
uncorrupted tensor (no sparse part).

PyTorch counterpart of `tritd_tpu/solvers/als.py` (reference:
`fast_robust_triple_tensor/triple_decomp_ALS.m:1-64`). ALS records the
relative error of the CURRENT factors first, checks the relative-change
stop, then does the three mode solves with a fixed 1e-9 ridge (`cfg.alpha_c`).

MALS (`triple_decomp_MALS.m`) is broken as committed; as in the reference
package, this is the repaired intent: the same mode updates, the error
recorded AFTER the sweep, and no early stop (always max_iter iterations).

On the card both run as the reference's `lax.while_loop` does
(`tritd_tpu/solvers/als.py:43-81`): the factors, the counter and the stop
flag on the card, the stop rule computed there, one iteration a replay of
a CUDA graph after the first (`admm._DeviceLoop`). ALS reads the flag
after each replay; MALS reads nothing until its max_iter iterations are
done. The host loop is the route of the CPU and of the solve methods
"pinv" and "lstsq" (`admm.UNCAPTURED_METHODS`).
"""

from __future__ import annotations

import torch

from .. import interop
from ..ops import designs, normal_eq
from ..ops.fold import core_a_from_mat, core_b_from_mat, core_c_from_mat
from ..ops.kruskal import solver_input
from . import admm
from .admm import init_factors
from .base import TriTDConfig, TriTDResult


def _als_sweep(x, a, b, c, cfg: TriTDConfig):
    """Three ridge mode solves with alpha = cfg.alpha_c
    (`triple_decomp_ALS.m:25-38`). The factors come back contiguous on
    every route: the device form carries them in contiguous buffers, and
    GEMMs may round otherwise on other layouts."""
    r, variant, method, alpha = cfg.rank, cfg.variant, cfg.solve_method, cfg.alpha_c
    k1, rhs1 = normal_eq.gram_and_rhs(1, x, a, b, c, variant=variant)
    a = core_a_from_mat(normal_eq.ridge_solve(k1, rhs1, alpha, method), r)
    k2, rhs2 = normal_eq.gram_and_rhs(2, x, a, b, c, variant=variant)
    b = core_b_from_mat(normal_eq.ridge_solve(k2, rhs2, alpha, method), r)
    k3, rhs3 = normal_eq.gram_and_rhs(3, x, a, b, c, variant=variant)
    c = core_c_from_mat(normal_eq.ridge_solve(k3, rhs3, alpha, method), r)
    return a.contiguous(), b.contiguous(), c.contiguous()


def _als_iteration(x, a, b, c, k, err_hist, cfg: TriTDConfig, mals: bool, norm_x):
    """One iteration from the factors, the error written into err_hist at k
    (a host int or a 0-d index tensor): the next factors and, for ALS, the
    stop flag (`admm._relative_change_stop`), for MALS None."""
    def rel_err(a, b, c):
        xhat = designs.triple_product(a, b, c, variant=cfg.variant)
        return torch.linalg.vector_norm(x - xhat) / norm_x

    if mals:
        # sweep first, then record the post-sweep error; no stop
        a, b, c = _als_sweep(x, a, b, c, cfg)
        admm._write(err_hist, k, rel_err(a, b, c))
        return a, b, c, None
    # record the incoming factors' error, stop on relative change, then
    # sweep (`triple_decomp_ALS.m:16-38`)
    err = rel_err(a, b, c)
    admm._write(err_hist, k, err)
    done = admm._relative_change_stop(err_hist, k, err, cfg.tol)
    return (*_als_sweep(x, a, b, c, cfg), done)


def _als_run(x, cfg: TriTDConfig, mals: bool, init, generator, graphs: bool | None) -> TriTDResult:
    """The solve of `x` (a tensor in cfg.dtype): with `graphs` None the host
    loop, which reads the ALS stop flag after every iteration, else the
    device form (`admm._DeviceLoop`), its blocks replayed as CUDA graphs
    when `graphs` is True: ALS reads the flag after each iteration, MALS,
    which has no stop, reads nothing until its max_iter iterations are
    done."""
    dtype = cfg.torch_dtype()
    norm_x = torch.linalg.vector_norm(x)
    if init is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init = init_factors(generator, tuple(x.shape), cfg.rank, dtype, x.device)
    a, b, c = interop.factors_from_numpy(*init, device=x.device, dtype=dtype)
    err_hist = torch.full((cfg.max_iter,), float("nan"), dtype=dtype, device=x.device)

    if graphs is None:
        k = 0
        done = False
        while k < cfg.max_iter and not done:
            a, b, c, flag = _als_iteration(x, a, b, c, k, err_hist, cfg, mals, norm_x)
            done = flag is not None and bool(flag)
            k += 1
    else:
        def iteration(carry, _data, _out):
            k = carry["k"]
            a, b, c, flag = _als_iteration(x, carry["a"], carry["b"], carry["c"], k, err_hist, cfg, mals, norm_x)
            return dict(a=a, b=b, c=c, k=k + 1, **({} if flag is None else {"done": flag}))

        carry = dict(a=a.clone(), b=b.clone(), c=c.clone(), k=torch.zeros((), dtype=torch.int64, device=x.device),
                     done=torch.zeros((), dtype=torch.bool, device=x.device))
        loop = admm._DeviceLoop(iteration, carry, (), cfg.max_iter, x.device, graphs, stops=not mals)
        carry, _data = loop.advance(cfg.max_iter)
        a, b, c, k = carry["a"], carry["b"], carry["c"], loop.k
    zeros = torch.zeros_like(x)
    return TriTDResult(a=a, b=b, c=c, o=zeros, e=zeros,
                       err_hist=err_hist, rre_hist=err_hist, n_iters=k)


def tritd_als(x, cfg: TriTDConfig = TriTDConfig(tol=1e-5), init=None,
              generator: torch.Generator | None = None, device=None) -> TriTDResult:
    """Alternating-LS TriTD fit of an uncorrupted tensor, on the device of `x`
    (`device` as for `tritd_admm`)."""
    x = solver_input(x, cfg.torch_dtype(), device)
    return _als_run(x, cfg, False, init, generator,
                    graphs=True if admm._graph_route(x.device, method=cfg.solve_method) else None)


def tritd_mals(x, cfg: TriTDConfig = TriTDConfig(), init=None,
               generator: torch.Generator | None = None, device=None) -> TriTDResult:
    """Repaired MALS variant (see module docstring); `device` as for
    `tritd_admm`."""
    x = solver_input(x, cfg.torch_dtype(), device)
    return _als_run(x, cfg, True, init, generator,
                    graphs=True if admm._graph_route(x.device, method=cfg.solve_method) else None)
