"""Robust TriTD-ADMM solver.

PyTorch counterpart of `tritd_tpu/solvers/admm.py`, with the semantics of
`fast_robust_triple_tensor/triple_decomp_ADMM.m:31-66`:

  per iteration k:
    T   = D - O + Y_L / muL
    A  <- ridge-LS rows of unfold(T,1) against design F(B, C)   (alpha = lambda2)
    B  <- ridge-LS against G(A, C)                              (alpha = lambda2)
    C  <- ridge-LS against H(A, B)                              (alpha = 1e-9)
    L   = triple_product(A, B, C)
    O, E, Y_L, Y_O, ||D-L-O||^2, ||O-E||^2 <- fused elementwise block
    muL = min(muL*rho, mu*1e6); muO likewise
    err[k] = (||D-L-O|| + ||O-E||) / ||D||
    stop when |err[k] - err[k-1]| < tol * err[k-1]

Everything runs on the device of `d`. The loop is a host loop; the penalties
and the counter are host numbers (numpy scalars of cfg.dtype, so the
annealing rounds as the reference's float32 `min(mu*rho, cap)` does), and
the only device-to-host read is the sticky stop flag, once per block of
`cfg.unroll` iterations. On a CUDA device the elementwise block is the
hand-written kernel; it also writes the next iteration's T.

Narrow storage (`cfg.storage_dtype`: bfloat16, float16, float8_e4m3fn or
float8_e5m2) keeps D, O, E, Y_L, Y_O and T in that dtype; the factors,
penalties, sums and histories stay in cfg.dtype, and the block widens its
inputs and rounds its stores. `cfg.einsum_dtype` stores T in its dtype and
rounds the RHS contractions' operands to it. Every narrowing goes through
`ops.narrow.narrow_cast`, which rounds as the reference's `astype` does
(once from float64; NaN past float8_e4m3fn's range).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import interop
from ..ops import designs, normal_eq
from ..ops.fold import core_a_from_mat, core_b_from_mat, core_c_from_mat
from ..ops.hopper_kernels import elementwise_block
from ..ops.kruskal import default_device, solver_input
from ..ops.narrow import narrow_cast
from .base import TriTDConfig, TriTDResult, TriTDState


def t_dtype_of(cfg: TriTDConfig) -> torch.dtype | None:
    """Dtype the carried factor-solve target `t` is stored in: the einsum
    dtype when set, else the narrow storage dtype when set, else None
    (= cfg.dtype). Counterpart of `tritd_tpu/solvers/admm.py:47-55`; shared
    with checkpoint load so that a resumed state carries the same dtypes."""
    ed = cfg.torch_einsum_dtype()
    if ed is not None:
        return ed
    sd = cfg.torch_storage_dtype()
    return sd if sd != cfg.torch_dtype() else None


def init_factors(
    generator: torch.Generator,
    shape: tuple[int, int, int],
    rank: int,
    dtype: torch.dtype,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Standard-normal factor init (reference: `randn`,
    `triple_decomp_ADMM.m:24`). Drawn on the CPU from `generator`, so one
    seed gives one init on every device, then moved to `device`: the card
    by default, as the reference draws on its accelerator (`RuntimeError`
    without CUDA; `device="cpu"` keeps the draw on the host)."""
    device = default_device(device)
    n1, n2, n3 = shape
    dims = ((n1, rank, rank), (rank, n2, rank), (rank, rank, n3))
    return tuple(
        torch.randn(s, generator=generator, dtype=dtype).to(device) for s in dims
    )


def update_factors(t, a, b, c, cfg: TriTDConfig, shard=None):
    """One Gauss-Seidel sweep of the three ridge mode solves
    (`triple_decomp_ADMM.m:73-95`); each later solve sees the fresh factors.

    `shard` says where sums are completed when `t` is one shard of the
    tensor: an object with `shard_mode` (1: `t` holds mode-1 slabs and `a`
    their rows; 3: `t` holds mode-3 frames and `c` those frames) and
    `all_reduce(tensor)`, which sums over the shards and returns the sum.
    None means `t` is the whole tensor."""
    r, variant, method = cfg.rank, cfg.variant, cfg.solve_method
    ed = cfg.torch_einsum_dtype()
    if ed is None:
        # a narrow T is widened once per sweep, not once per mode
        t = t.to(a.dtype)
    if shard is not None:
        return _update_factors_sharded(t, a, b, c, cfg, shard)
    k1, rhs1 = normal_eq.gram_and_rhs(1, t, a, b, c, variant=variant, einsum_dtype=ed)
    a = core_a_from_mat(normal_eq.ridge_solve(k1, rhs1, cfg.lambda2, method), r)
    k2, rhs2 = normal_eq.gram_and_rhs(2, t, a, b, c, variant=variant, einsum_dtype=ed)
    b = core_b_from_mat(normal_eq.ridge_solve(k2, rhs2, cfg.lambda2, method), r)
    k3, rhs3 = normal_eq.gram_and_rhs(3, t, a, b, c, variant=variant, einsum_dtype=ed)
    c = core_c_from_mat(normal_eq.ridge_solve(k3, rhs3, cfg.alpha_c, method), r)
    # The solves hand back strided views. Carried as they are, the next
    # iteration's GEMMs would see other layouts than the contiguous factors
    # of a loaded checkpoint, and cuBLAS picks its kernel, and so its
    # rounding, by layout: contiguous factors make a resumed run bitwise
    # equal to one that never stopped.
    return a.contiguous(), b.contiguous(), c.contiguous()


def _update_factors_sharded(t, a, b, c, cfg: TriTDConfig, shard):
    """The sweep on one shard, with the collective placement of
    `tritd_tpu/parallel/sharded_admm.py:62-114`. A sum over the sharded
    index is completed by `shard.all_reduce`; a sum over the other indices
    is whole on every shard. Mode-1 slabs shard i: GramA and the mode-2/3
    right-hand sides are reduced and the A solve is local. Mode-3 frames
    shard t: GramC (before the first solve) and the mode-1/2 right-hand
    sides are reduced and the C solve is local. Solves on reduced inputs
    give the same B, C (mode 1) or A, B (mode 3) on every shard."""
    r, variant, method = cfg.rank, cfg.variant, cfg.solve_method
    ed = cfg.torch_einsum_dtype()
    if shard.shard_mode not in (1, 3):
        raise ValueError(f"shard_mode must be 1 or 3, got {shard.shard_mode}")
    over_i, over_t = (shard.all_reduce, _whole) if shard.shard_mode == 1 else (_whole, shard.all_reduce)

    gc = over_t(normal_eq.gram_c(c))
    k1 = normal_eq.combine_grams(1, None, normal_eq.gram_b(b), gc, variant)
    rhs1 = over_t(normal_eq.rhs_mode(1, t, a, b, c, variant=variant, einsum_dtype=ed))
    a = core_a_from_mat(normal_eq.ridge_solve(k1, rhs1, cfg.lambda2, method), r)

    ga = over_i(normal_eq.gram_a(a))
    k2 = normal_eq.combine_grams(2, ga, None, gc, variant)
    rhs2 = shard.all_reduce(normal_eq.rhs_mode(2, t, a, b, c, variant=variant, einsum_dtype=ed))
    b = core_b_from_mat(normal_eq.ridge_solve(k2, rhs2, cfg.lambda2, method), r)

    k3 = normal_eq.combine_grams(3, ga, normal_eq.gram_b(b), None, variant)
    rhs3 = over_i(normal_eq.rhs_mode(3, t, a, b, c, variant=variant, einsum_dtype=ed))
    c = core_c_from_mat(normal_eq.ridge_solve(k3, rhs3, cfg.alpha_c, method), r)
    return a.contiguous(), b.contiguous(), c.contiguous()


def _whole(x):
    return x


def admm_iteration(
    d: torch.Tensor,
    state: TriTDState,
    cfg: TriTDConfig,
    mask: torch.Tensor | None = None,
    origin: torch.Tensor | None = None,
    norm_d: torch.Tensor | None = None,
    norm_origin: torch.Tensor | None = None,
    disp_log: list | None = None,
    shard=None,
) -> TriTDState:
    """One ADMM iteration (`triple_decomp_ADMM.m:31-66`). The histories are
    written in place (entry k). With cfg.disp, every 10th iteration appends
    (k, errL, errO) to `disp_log` as device scalars, for the caller to print.

    With `shard` (see :func:`update_factors`), `d`, `mask`, `origin` and the
    data-sized state are one shard; `norm_d` and `norm_origin` must then be
    given, taken over the whole tensor. The two sums of squares, and the
    RRE numerator when `origin` is given, are reduced as sums in one small
    vector before their roots are taken, so the error and the stop flag are
    equal on every shard."""
    a, b, c = state.a, state.b, state.c
    o, e, y_l, y_o = state.o, state.e, state.y_l, state.y_o
    mu_l, mu_o, k = state.mu_l, state.mu_o, state.k
    if shard is not None and (norm_d is None or (origin is not None and norm_origin is None)):
        raise ValueError("a sharded iteration needs norm_d (and norm_origin) of the whole tensor")
    if norm_d is None:
        norm_d = torch.linalg.vector_norm(d)

    masked = cfg.masked and mask is not None
    td = t_dtype_of(cfg)
    if masked:
        # Impute unobserved entries with the current estimate, so the data
        # term binds on observed entries only; T is built from that D. The
        # reference's jnp.where promotes the imputed D: to the compute dtype
        # beside narrow storage, to float64 beside float64 storage at
        # float32 compute. T is formed in that dtype; the block gets D in
        # the compute dtype, which holds it exactly (the stored D and O
        # hold values of the compute dtype).
        l_prev = designs.triple_product(a, b, c, variant=cfg.variant)
        cd = l_prev.dtype
        wide = torch.float64 if torch.float64 in (cd, d.dtype) else cd
        d = torch.where(mask, d.to(wide), (l_prev + o.to(cd)).to(wide))
        t = d - o.to(wide) + y_l.to(wide) / float(mu_l)
        d = d.to(cd)
        if td is not None:
            t = narrow_cast(t, td)
    else:
        t = state.t

    a, b, c = update_factors(t, a, b, c, cfg, shard=shard)
    l = designs.triple_product(a, b, c, variant=cfg.variant)

    dt = cfg.np_dtype().type
    mu_cap = dt(cfg.mu * cfg.mu_cap_factor)
    mu_l_next = np.minimum(mu_l * dt(cfg.rho), mu_cap)
    mu_o_next = np.minimum(mu_o * dt(cfg.rho), mu_cap)

    # Masked mode rebuilds T from the freshly imputed D each iteration, so
    # the block skips T' and the state's T passes through.
    o, e, y_l, y_o, sq_l, sq_o, t_next = elementwise_block(
        d, l, e, y_l, y_o, mu_l, mu_o, cfg.lambda_l1,
        mu_l_next=None if masked else mu_l_next, t_dtype=td,
    )
    if masked:
        t_next = state.t

    sq_rre = None
    if shard is not None:
        sums = [sq_l, sq_o]
        if origin is not None:
            diff = l - origin
            sums.append(torch.sum(diff * diff))
        sq_l, sq_o, *rest = shard.all_reduce(torch.stack(sums))
        sq_rre = rest[0] if rest else None
    root_l, root_o = torch.sqrt(sq_l), torch.sqrt(sq_o)
    err = (root_l + root_o) / norm_d
    if cfg.disp and disp_log is not None and (k + 1) % 10 == 0:
        disp_log.append((k + 1, root_l / norm_d, root_o / norm_d))
    err_hist = state.err_hist
    err_hist[k] = err

    rre_hist = state.rre_hist
    if sq_rre is not None:
        rre_hist[k] = torch.sqrt(sq_rre) / norm_origin
    elif origin is not None:
        if norm_origin is None:
            norm_origin = torch.linalg.vector_norm(origin)
        rre_hist[k] = torch.linalg.vector_norm(l - origin) / norm_origin

    # relative-change stopping rule (`:63-65`); sticky, so that a block of
    # unrolled iterations cannot un-converge
    done = state.done
    if k >= 1:
        err_prev = err_hist[k - 1]
        done = done | (torch.abs(err - err_prev) < cfg.tol * err_prev)

    return TriTDState(
        a=a, b=b, c=c, o=o, e=e, y_l=y_l, y_o=y_o, t=t_next,
        mu_l=mu_l_next, mu_o=mu_o_next, k=k + 1,
        err_hist=err_hist, rre_hist=rre_hist, done=done,
    )


def init_state(d: torch.Tensor, cfg: TriTDConfig, factors) -> TriTDState:
    """Initial state for data `d` with factor init `factors` = (a, b, c)."""
    dtype = cfg.torch_dtype()
    d = d.to(dtype)
    a, b, c = interop.factors_from_numpy(*factors, device=d.device, dtype=dtype)
    # data-sized state in the (possibly narrow) storage dtype; factors,
    # penalties and histories in the solver dtype
    zeros = torch.zeros_like(d, dtype=cfg.torch_storage_dtype())
    # padded to a multiple of cfg.unroll: a block may overshoot max_iter by
    # up to unroll-1 iterations
    hist_len = -(-cfg.max_iter // cfg.unroll) * cfg.unroll
    nan_hist = torch.full((hist_len,), float("nan"), dtype=dtype, device=d.device)
    mu = cfg.np_dtype().type(cfg.mu)
    td = t_dtype_of(cfg)
    return TriTDState(
        a=a, b=b, c=c, o=zeros, e=zeros, y_l=zeros, y_o=zeros,
        t=d if td is None else narrow_cast(d, td),  # T_0 = D - 0 + 0/mu = D
        mu_l=mu, mu_o=mu, k=0,
        err_hist=nan_hist, rre_hist=nan_hist.clone(),
        done=torch.zeros((), dtype=torch.bool, device=d.device),
    )


def run_admm(d, state: TriTDState, cfg: TriTDConfig, mask=None, origin=None,
             norm_d=None, norm_origin=None, shard=None) -> TriTDState:
    """Iterate from `state` to cfg.max_iter or the stop rule, in blocks of
    cfg.unroll iterations; the sticky stop flag is the only device-to-host
    read, once per block. With `shard` (see :func:`admm_iteration`) the flag
    comes from reduced sums, so every shard leaves the loop together."""
    disp_log: list = []
    while state.k < cfg.max_iter and not bool(state.done):
        for _ in range(cfg.unroll):
            state = admm_iteration(
                d, state, cfg, mask=mask, origin=origin,
                norm_d=norm_d, norm_origin=norm_origin, disp_log=disp_log, shard=shard,
            )
        for it, el, eo in disp_log:
            print(f"Iter {it}, errL={float(el):.2e}, errO={float(eo):.2e}")
        disp_log.clear()
    return state


def tritd_admm(
    d,
    cfg: TriTDConfig = TriTDConfig(),
    mask=None,
    origin=None,
    init=None,
    generator: torch.Generator | None = None,
    device=None,
) -> TriTDResult:
    """Run robust TriTD-ADMM on a 3-way tensor, on the device of `d`.

    Args:
      d: observed (possibly corrupted/zero-filled) tensor (n1, n2, n3).
      cfg: hyperparameters; defaults = completion driver preset.
      mask: bool tensor of *observed* entries (required iff cfg.masked).
      origin: optional ground truth; per-iteration ||L - origin||/||origin||
        is recorded in rre_hist.
      init: optional factor init (a0, b0, c0), numpy arrays or tensors, e.g.
        the reference's `init_factors` draw carried over with
        :mod:`tritd_tpu_torch.interop`.
      generator: CPU generator for the init when `init` is None (default:
        seed 0, mirroring the reference's `rng(0)`).
      device: where a `d` that is not a tensor goes (default: the card;
        `RuntimeError` without CUDA); a tensor `d` keeps its device unless
        `device` names another. mask and origin follow `d`.
    """
    if cfg.masked and mask is None:
        raise ValueError("cfg.masked=True requires a mask argument")
    if mask is not None and not cfg.masked:
        raise ValueError("mask given but cfg.masked=False — pass TriTDConfig(masked=True)")
    dtype = cfg.torch_dtype()
    d = solver_input(d, dtype, device)
    device = d.device
    if mask is not None:
        mask = torch.as_tensor(mask, device=device).to(torch.bool)
    norm_origin = None
    if origin is not None:
        origin = torch.as_tensor(origin, device=device).to(dtype)
        norm_origin = torch.linalg.vector_norm(origin)
    norm_d = torch.linalg.vector_norm(d)
    if init is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init = init_factors(generator, tuple(d.shape), cfg.rank, dtype, device)
    state = init_state(d, cfg, init)
    # the loop reads D every iteration: store it narrow too (norm_d above
    # is taken from the full-precision copy)
    d = narrow_cast(d, cfg.torch_storage_dtype())

    state = run_admm(d, state, cfg, mask=mask, origin=origin, norm_d=norm_d, norm_origin=norm_origin)

    return TriTDResult(
        a=state.a, b=state.b, c=state.c, o=state.o.to(dtype), e=state.e.to(dtype),
        err_hist=state.err_hist[: cfg.max_iter],
        rre_hist=state.rre_hist[: cfg.max_iter],
        n_iters=min(state.k, cfg.max_iter),
    )
