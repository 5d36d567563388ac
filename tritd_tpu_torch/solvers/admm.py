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

Everything runs on the device of `d`. On a CUDA device `tritd_admm` runs
as the reference's `lax.while_loop` under `jit` does
(`tritd_tpu/solvers/admm.py:226-260`): each block of `cfg.unroll`
iterations is one replay of a captured CUDA graph, and the penalties muL,
muO and the counter k live in device memory, annealed and advanced by the
graph (`_run_device_form`). The host reads the sticky stop flag once per block
and the penalties once at the end. The elementwise block is the
hand-written kernel, through its pointer entry, which reads the penalties
from device memory; it also writes the next iteration's T. The sharded
solve over NCCL takes the same route, as the reference's `shard_map`ped
`while_loop` does (`tritd_tpu/parallel/sharded_admm.py:15-16,211`): the
graph holds the block's `all_reduce` calls.

The eager loop (`run_admm(..., _eager=True)`, and on the CPU) runs the same
`admm_iteration` with the penalties and the counter as host numbers (numpy
scalars of cfg.dtype, so the annealing rounds as the reference's float32
`min(mu*rho, cap)` does; the device form rounds alike). It is the route of
the sharded solve over gloo (which passes a CUDA tensor's collective
through the host, where no graph can capture it), of
`tritd_admm_checkpointed`, and of the CPU.

Narrow storage (`cfg.storage_dtype`: bfloat16, float16, float8_e4m3fn or
float8_e5m2) keeps D, O, E, Y_L, Y_O and T in that dtype; the factors,
penalties, sums and histories stay in cfg.dtype, and the block widens its
inputs and rounds its stores. `cfg.einsum_dtype` stores T in its dtype and
rounds the RHS contractions' operands to it. Every narrowing goes through
`ops.narrow.narrow_cast`, which rounds as the reference's `astype` does
(once from float64; NaN past float8_e4m3fn's range).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import interop
from ..ops import designs, normal_eq
from ..ops.fold import core_a_from_mat, core_b_from_mat, core_c_from_mat
from ..ops import hopper_kernels
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


def anneal(mu, cfg: TriTDConfig):
    """The next penalty, min(mu * rho, mu0 * cap) in cfg.dtype
    (`tritd_tpu/solvers/admm.py:146-148`): for a host penalty a numpy
    scalar, for a 0-d tensor a tensor on its device, computed there. Both
    round rho and the cap to cfg.dtype and take one rounded product, so
    they give the same bits."""
    cap = cfg.mu * cfg.mu_cap_factor
    if isinstance(mu, torch.Tensor):
        return torch.clamp(mu * cfg.rho, max=cap)
    dt = cfg.np_dtype().type
    return np.minimum(mu * dt(cfg.rho), dt(cap))


def _reciprocal(mu, dtype: torch.dtype):
    """1/mu rounded to `dtype`: for a host penalty a Python float, for a 0-d
    tensor a tensor computed on its device. The masked T multiplies Y_L by
    it, as PyTorch's CUDA division by a host number does, so that both
    forms of the penalty, on either device, give the same bits."""
    if isinstance(mu, torch.Tensor):
        return torch.reciprocal(mu.to(dtype))
    np_t = np.dtype(str(dtype).removeprefix("torch.")).type
    return float(np_t(1) / np_t(mu))


def _write(hist: torch.Tensor, k, value: torch.Tensor) -> None:
    """hist[..., k] = value in place, k a host int or a 0-d index tensor."""
    if isinstance(k, torch.Tensor):
        hist.index_copy_(hist.dim() - 1, k.view(1), value.to(hist.dtype).reshape(*hist.shape[:-1], 1))
    else:
        hist[..., k] = value


def admm_iteration(
    d: torch.Tensor,
    state: TriTDState,
    cfg: TriTDConfig,
    mask: torch.Tensor | None = None,
    origin: torch.Tensor | None = None,
    norm_d: torch.Tensor | None = None,
    norm_origin: torch.Tensor | None = None,
    disp_log=None,
    shard=None,
    out=None,
) -> TriTDState:
    """One ADMM iteration (`triple_decomp_ADMM.m:31-66`). The histories are
    written in place (entry k).

    The state's penalties and counter are host numbers (numpy scalars, an
    int) or, in the device form, 0-d tensors on d's device: then nothing is
    read back to the host, so that a CUDA graph can capture the iteration,
    and the stop rule takes the reference's form (err_prev read at
    max(k-1, 0) and k >= 1 tested on the device). Both forms give the same
    bits. With cfg.disp, the host form appends (k, errL, errO) to the list
    `disp_log` every 10th iteration, as device scalars, for the caller to
    print; the device form writes (errL, errO) into column k of the
    (2, hist_len) tensor `disp_log` every iteration.

    `out` = (o, e, y_l, y_o, t) buffers that the elementwise block stores
    into instead of new tensors (t None when masked), none of them a tensor
    of `state`.

    With `shard` (see :func:`update_factors`), in either form, `d`, `mask`,
    `origin` and the data-sized state are one shard; `norm_d` and
    `norm_origin` must then be given, taken over the whole tensor. The two
    sums of squares, and the RRE numerator when `origin` is given, are
    reduced as sums in one small vector before their roots are taken, so
    the error and the stop flag are equal on every shard."""
    a, b, c = state.a, state.b, state.c
    o, e, y_l, y_o = state.o, state.e, state.y_l, state.y_o
    mu_l, mu_o, k = state.mu_l, state.mu_o, state.k
    on_device = isinstance(k, torch.Tensor)
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
        # float32 compute. T is formed in that dtype, with Y_L/muL taken as
        # Y_L times the rounded 1/muL; the block gets D in the compute
        # dtype, which holds it exactly (the stored D and O hold values of
        # the compute dtype).
        l_prev = designs.triple_product(a, b, c, variant=cfg.variant)
        cd = l_prev.dtype
        wide = torch.float64 if torch.float64 in (cd, d.dtype) else cd
        d = torch.where(mask, d.to(wide), (l_prev + o.to(cd)).to(wide))
        t = d - o.to(wide) + y_l.to(wide) * _reciprocal(mu_l, wide)
        d = d.to(cd)
        if td is not None:
            t = narrow_cast(t, td)
    else:
        t = state.t

    a, b, c = update_factors(t, a, b, c, cfg, shard=shard)
    l = designs.triple_product(a, b, c, variant=cfg.variant)

    mu_l_next = anneal(mu_l, cfg)
    mu_o_next = anneal(mu_o, cfg)

    # Masked mode rebuilds T from the freshly imputed D each iteration, so
    # the block skips T' and the state's T passes through.
    o, e, y_l, y_o, sq_l, sq_o, t_next = elementwise_block(
        d, l, e, y_l, y_o, mu_l, mu_o, cfg.lambda_l1,
        mu_l_next=None if masked else mu_l_next, t_dtype=td, out=out,
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
    if cfg.disp and disp_log is not None:
        if on_device:
            _write(disp_log, k, torch.stack((root_l, root_o)) / norm_d)
        elif (k + 1) % 10 == 0:
            disp_log.append((k + 1, root_l / norm_d, root_o / norm_d))
    err_hist = state.err_hist
    _write(err_hist, k, err)

    rre_hist = state.rre_hist
    if sq_rre is not None:
        _write(rre_hist, k, torch.sqrt(sq_rre) / norm_origin)
    elif origin is not None:
        if norm_origin is None:
            norm_origin = torch.linalg.vector_norm(origin)
        _write(rre_hist, k, torch.linalg.vector_norm(l - origin) / norm_origin)

    # relative-change stopping rule (`:63-65`); sticky, so that a block of
    # unrolled iterations cannot un-converge
    done = state.done
    if on_device:
        err_prev = err_hist.index_select(0, torch.clamp(k - 1, min=0).view(1)).view(())
        done = done | ((k >= 1) & (torch.abs(err - err_prev) < cfg.tol * err_prev))
    elif k >= 1:
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
             norm_d=None, norm_origin=None, shard=None, _eager: bool = False) -> TriTDState:
    """Iterate from `state` to cfg.max_iter or the stop rule, in blocks of
    cfg.unroll iterations, reading the sticky stop flag between blocks.

    On the route that :func:`_graph_route` picks, each block is one replay
    of a CUDA graph (`_run_device_form`); otherwise the eager loop runs,
    whose only device-to-host read is that flag. With `shard` (see
    :func:`admm_iteration`) the flag comes from reduced sums, so every shard
    leaves the loop together. Either way the state comes back in its host
    form."""
    if _graph_route(d.device, shard, _eager):
        return _run_device_form(d, state, cfg, mask, origin, norm_d, norm_origin, graphs=True, shard=shard)
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


def _graph_route(device: torch.device, shard=None, eager: bool = False) -> bool:
    """Whether `run_admm` replays CUDA graphs: on a CUDA device, unless
    `eager` (for the comparison of the two routes), when there is no shard
    or the shard's collective can be captured: a shard given to `run_admm`
    says so with `capturable` (a NCCL group; not gloo, which passes a CUDA
    tensor's collective through the host) and keeps its counts in the dict
    `tally`, which each replay adds to (`hopper_kernels.CountedGraph`).
    Every rank of a group must take the same route, or a collective
    captured on one would meet an eager one on another: the backend is the
    group's, and the caller passes the same `eager` on every rank."""
    return device.type == "cuda" and not eager and (shard is None or shard.capturable)


# The fields of the device form that a block carries in place: the factors,
# the penalties, the counter and the stop flag. The data-sized fields take
# turns in two sets of buffers instead, and the histories are written in place.
_CARRIED = ("a", "b", "c", "mu_l", "mu_o", "k", "done")


def _run_device_form(d, state: TriTDState, cfg: TriTDConfig, mask, origin, norm_d, norm_origin,
                     graphs: bool, shard=None) -> TriTDState:
    """The loop of `run_admm` on the device form of the state: the
    penalties and the counter become 0-d tensors on d's device, and each
    block of cfg.unroll iterations is one call of the same function of
    device tensors, with no read back to the host inside it.

    The state carries across blocks without a data-sized copy. The
    data-sized fields take turns in two sets of buffers: the iteration that
    starts from one set has the kernel store into the other. The factors,
    penalties, counter and stop flag are copied at the end of each block
    into buffers that the next block reads (a few (n, r^2) and 0-d
    tensors). The block is a function of the iterations done before it
    only through their parity, so with `graphs` (a CUDA device) the first
    block runs eagerly on a side stream, warming cuBLAS, cuSOLVER and the
    kernel's scratch there, and the later ones replay one graph captured
    per parity (one when cfg.unroll is even). Without `graphs` every block
    runs eagerly: the CPU tests hold this route to the eager loop.

    With `shard` every iteration completes its sums through it; with
    `graphs` its collectives, NCCL's, are nodes of the graph. The first
    block, eager, makes the communicator's work on the side stream before
    any capture (the caller's norms have made the communicator), and the
    graph counts the calls it holds in `shard.tally` at each replay.

    The host reads the stop flag before each block, (errL, errO) of the
    block's 10th iterations with cfg.disp, and the penalties once at the
    end, which must equal the host's numpy schedule bitwise. A failed
    capture raises."""
    masked = cfg.masked and mask is not None
    if norm_d is None:
        norm_d = torch.linalg.vector_norm(d)
    if origin is not None and norm_origin is None:
        norm_origin = torch.linalg.vector_norm(origin)
    device, dtype = d.device, cfg.torch_dtype()
    k0 = state.k
    carry = state._replace(
        a=state.a.clone(), b=state.b.clone(), c=state.c.clone(),
        mu_l=torch.full((), float(state.mu_l), dtype=dtype, device=device),
        mu_o=torch.full((), float(state.mu_o), dtype=dtype, device=device),
        k=torch.full((), k0, dtype=torch.int64, device=device), done=state.done.clone(),
    )
    fields = ("o", "e", "y_l", "y_o") if masked else ("o", "e", "y_l", "y_o", "t")
    sets = [tuple(torch.empty_like(getattr(state, f), memory_format=torch.contiguous_format) for f in fields)
            for _ in range(2)]
    disp_hist = (torch.full((2, state.err_hist.shape[0]), float("nan"), dtype=state.err_hist.dtype, device=device)
                 if cfg.disp else None)

    def block(done_before: int) -> None:
        """cfg.unroll iterations from the state after `done_before` of them."""
        if done_before == 0:
            st = carry._replace(o=state.o, e=state.e, y_l=state.y_l, y_o=state.y_o, t=state.t)
        else:
            st = carry._replace(**dict(zip(fields, sets[done_before % 2])))
        for i in range(cfg.unroll):
            out = sets[(done_before + i + 1) % 2]
            st = admm_iteration(d, st, cfg, mask=mask, origin=origin, norm_d=norm_d, norm_origin=norm_origin,
                                disp_log=disp_hist, shard=shard, out=out if not masked else (*out, None))
        for f in _CARRIED:
            getattr(carry, f).copy_(getattr(st, f))

    n_done = 0  # iterations this call has run
    with contextlib.ExitStack() as stack:
        if graphs:
            caller, side = torch.cuda.current_stream(device), torch.cuda.Stream(device=device)
            side.wait_stream(caller)
            # unwound last in, first out: the side stream is left, then the
            # caller's stream waits for its work
            stack.callback(caller.wait_stream, side)
            stack.enter_context(torch.cuda.stream(side))
            captured: dict = {}
            pool = torch.cuda.graph_pool_handle()
            tallies = () if shard is None else (shard.tally,)
        while k0 + n_done < cfg.max_iter and not bool(carry.done):
            if graphs and n_done > 0:
                parity = n_done % 2
                if parity not in captured:
                    captured[parity] = hopper_kernels.CountedGraph(lambda: block(n_done), pool, tallies)
                captured[parity].replay()
            else:
                block(n_done)
            if cfg.disp:
                _print_disp(disp_hist, k0 + n_done, k0 + n_done + cfg.unroll)
            n_done += cfg.unroll

    mu = torch.stack((carry.mu_l, carry.mu_o)).cpu().numpy()
    want = np.array([state.mu_l, state.mu_o], dtype=cfg.np_dtype())
    for _ in range(n_done):
        want = anneal(want, cfg)
    if mu.tobytes() != want.tobytes():
        raise AssertionError(f"the penalties on {device} after {n_done} iterations, {mu}, are not the host's "
                             f"schedule {want}")
    last = dict(zip(fields, sets[n_done % 2])) if n_done else {}
    return state._replace(a=carry.a, b=carry.b, c=carry.c, **last, mu_l=mu[0], mu_o=mu[1], k=k0 + n_done,
                          done=carry.done)


def _print_disp(disp_hist: torch.Tensor, k_from: int, k_to: int) -> None:
    """The disp lines of iterations k_from+1..k_to that are multiples of 10."""
    its = [it for it in range(k_from + 1, k_to + 1) if it % 10 == 0 and it <= disp_hist.shape[1]]
    if its:
        rows = disp_hist[:, [it - 1 for it in its]].cpu()
        for it, el, eo in zip(its, rows[0].tolist(), rows[1].tolist()):
            print(f"Iter {it}, errL={el:.2e}, errO={eo:.2e}")


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
