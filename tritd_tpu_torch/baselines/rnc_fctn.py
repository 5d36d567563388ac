"""RNC-FCTN: robust tensor completion by PAM on explicit FCTN factors.

PyTorch counterpart of `tritd_tpu/baselines/rnc_fctn.py`. Reference:
`other_methods/IPI_RTC_FCTN-main/RTC_FCTN/RNC_FCTN.m:1-117` with the FCTN
composition helpers `tnprod/tnprod_rest/tensor_contraction/tnreshape`
(vendored in the reference, exercised by `Demo_RNC_FCTN.m`; the benchmark
drivers call the nuclear-norm sister `RC_FCTN` instead).

For a 4-way tensor the FCTN factors are four 4-way cores sharing pairwise
rank bonds r_ij (rank matrix R upper-triangular):

    G1[n1, r12, r13, r14]   G2[r12, n2, r23, r24]
    G3[r13, r23, n3, r34]   G4[r14, r24, r34, n4]
    X[a,b,c,d] = einsum('aqrs,qbtu,rtcv,suvd->abcd', G1, G2, G3, G4)

Per PAM iteration (`RNC_FCTN.m:56-95`): proximal ridge LS on each factor
against the composition of the others, proximal X / soft-threshold E /
observed-projection Y updates, beta *= rh, and adaptive FCTN-rank growth
(pad factors with a random scalar when the relative change stalls,
`rank_inc_adaptive` `:99-104`). The stop and the rank growth read the
relative change on the host every iteration, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kruskal import draw, solver_input
from ..ops.shrinkage import soft_threshold

_SPEC = "aqrs,qbtu,rtcv,suvd->abcd"
_REST_SPECS = {
    0: "qbtu,rtcv,suvd->qrsbcd",  # free: bond dims (q,r,s) + spatial (b,c,d)
    1: "aqrs,rtcv,suvd->qtuacd",
    2: "aqrs,qbtu,suvd->rtvabd",
    3: "aqrs,qbtu,rtcv->suvabc",
}


def _chain_einsum(spec: str, *operands: torch.Tensor) -> torch.Tensor:
    """`spec` contracted two operands at a time, left to right, each
    intermediate keeping the indices a later operand or the output needs.
    torch.einsum picks an order of its own only where opt_einsum is
    installed; this order is fixed."""
    ins, out = spec.split("->")
    terms = ins.split(",")
    acc, acc_idx = operands[0], terms[0]
    for pos in range(1, len(terms)):
        needed = set(out).union(*terms[pos + 1:])
        both = dict.fromkeys(acc_idx + terms[pos])
        keep = "".join(c for c in both if c in needed)
        acc = torch.einsum(f"{acc_idx},{terms[pos]}->{keep}", acc, operands[pos])
        acc_idx = keep
    return torch.einsum(f"{acc_idx}->{out}", acc)


def fctn_compose(gs) -> torch.Tensor:
    """`tnprod(G)` for N=4: the FCTN composition."""
    return _chain_einsum(_SPEC, *gs)


def _factor_matrices(gs, i):
    """(G_i unfolded (n_i, prod bonds), rest matrix (prod bonds, prod other
    spatial)) matching `my_Unfold` + `tnreshape(tnprod_rest)` semantics."""
    others = [g for j, g in enumerate(gs) if j != i]
    rest = _chain_einsum(_REST_SPECS[i], *others)
    bond_dims = tuple(rest.shape[:3])
    rest_mat = rest.reshape(int(np.prod(bond_dims)), -1)
    gi = gs[i]
    gi_mat = torch.movedim(gi, i, 0).reshape(gi.shape[i], -1)  # G_i's spatial axis is its i-th
    return gi_mat, rest_mat, bond_dims


def _update_factor(x, gs, rho, i):
    gi_mat, rest_mat, bond_dims = _factor_matrices(gs, i)
    n = x.shape[i]
    x_mat = torch.movedim(x, i, 0).reshape(n, -1)
    temp_c = x_mat @ rest_mat.T + rho * gi_mat
    k = rest_mat.shape[0]
    temp_a = rest_mat @ rest_mat.T + rho * torch.eye(k, dtype=x.dtype, device=x.device)
    # the reference's pinv cut-off (10 * max(M, N) * eps); torch's default
    # is ten times smaller
    gi_new_mat = temp_c @ torch.linalg.pinv(temp_a, rtol=10.0 * k * torch.finfo(x.dtype).eps)
    return torch.movedim(gi_new_mat.reshape((n, *bond_dims)), 0, i)


def _pam_step(f, omega, x, e, y, gs, lam, rho, beta):
    gs = list(gs)
    for i in range(4):
        gs[i] = _update_factor(x, gs, rho, i)
    x_old = x
    x = (fctn_compose(gs) + rho * x_old + beta * (y - e)) / (1.0 + rho + beta)
    e = soft_threshold((beta * (y - x) + rho * e) / (beta + rho), lam / (beta + rho))
    y = (beta * (x + e) + rho * y) / (beta + rho)
    y = torch.where(omega, f, y)
    rse = torch.linalg.vector_norm(x - x_old) / (torch.linalg.vector_norm(x_old) + 1e-30)
    return x, e, y, tuple(gs), rse


def _factor_dims(nway, rank: np.ndarray) -> np.ndarray:
    """tempdim(i,:) = diag(Nway) + R + R': the shape of G_i."""
    r = np.asarray(rank)
    return np.diag(nway) + r + r.T


def _init_factors(generator: torch.Generator, nway, rank: np.ndarray, dtype, device=None):
    """G_i ~ U[0,1) of shape tempdim(i,:), drawn on the generator's device
    (so one CPU seed gives one init on every device) and moved to `device`
    (None: left there)."""
    tempdim = _factor_dims(nway, rank)
    return tuple(
        draw("uniform", generator, tuple(int(v) for v in tempdim[i]), dtype, device or generator.device)
        for i in range(4)
    )


def _griddata_frames(vol: np.ndarray, mask: np.ndarray, fill: float) -> np.ndarray:
    """`lib/interpolate.m:1-18`: per-frame scattered LINEAR interpolation of
    the observed entries onto the full grid, NaN (outside the convex hull)
    filled with `fill`. The reference's meshgrid/permute transposes cancel;
    this is the direct equivalent on (row, col) coordinates."""
    from scipy.interpolate import griddata

    n1, n2, n3 = vol.shape
    gx, gy = np.mgrid[0:n1, 0:n2]
    out = np.empty_like(vol, dtype=np.float64)
    for t in range(n3):
        m = mask[:, :, t] > 0
        if int(m.sum()) < 3:  # griddata needs a non-degenerate triangulation
            out[:, :, t] = fill
            continue
        pts = np.argwhere(m).astype(np.float64)
        interp = griddata(pts, vol[:, :, t][m], (gx, gy), method="linear")
        np.nan_to_num(interp, copy=False, nan=fill)
        out[:, :, t] = interp
    return out


def interpolate_init(
    f: torch.Tensor,
    omega: torch.Tensor,
    pad: int = 20,
    fill: float = 128.0,
    clip: tuple[float, float] = (0.0, 1.0),
    device=None,
) -> torch.Tensor:
    """RNC-FCTN's interpolation warm start for `sample_ratio < 1`
    (`Demo_RNC_FCTN.m:37-55`): symmetric-pad the 3-way view by `pad`,
    linearly interpolate the observed entries in TWO shifted plane
    orientations ((d2, d3) planes per d1 slice and (d3, d1) planes per d2
    slice), clip each to `clip`, restore observed entries, and average
    0.5/0.5. The result replaces the zero-filled data tensor as RNC_FCTN's
    input (`:90` passes X1 as F). At sample_ratio 1 this is the identity on
    observed data.

    The `fill=128` on [0, 1]-scaled data is the reference's committed quirk
    (`interpolate.m:17`); it is clipped to `clip[1]` immediately, so the
    effective out-of-hull fill is the upper clip bound. Host-side numpy and
    scipy: one-time preprocessing, not a solve-loop path. The result lies
    where a tensor `f` lies unless `device` names another place; from numpy,
    on the card (`RuntimeError` without CUDA; `device="cpu"` for the plain
    path)."""
    f = solver_input(f, device=device)
    f_np = f.detach().cpu().numpy().astype(np.float64)
    om_np = torch.as_tensor(omega).cpu().numpy().astype(bool)
    nway = f_np.shape
    n1, n2 = nway[0], nway[1]
    a3 = f_np.reshape(n1, n2, -1)
    ind3 = om_np.reshape(n1, n2, -1).astype(np.float64)
    obs = om_np.reshape(n1, n2, -1)
    b = np.pad(a3, pad, mode="symmetric")
    c = np.pad(ind3, pad, mode="symmetric")
    lo, hi = clip
    sl = slice(pad, -pad)

    # a1: interpolate (d2, d3) planes across d1 (`shiftdim(B,1)`)
    r1 = _griddata_frames(b.transpose(1, 2, 0), c.transpose(1, 2, 0), fill)
    r1 = np.clip(r1, lo, hi)[sl, sl, sl].transpose(2, 0, 1)
    r1[obs] = a3[obs]
    # a2: interpolate (d3, d1) planes across d2 (`shiftdim(B,2)`)
    r2 = _griddata_frames(b.transpose(2, 0, 1), c.transpose(2, 0, 1), fill)
    r2 = np.clip(r2, lo, hi)[sl, sl, sl].transpose(1, 2, 0)
    r2[obs] = a3[obs]

    a = 0.5 * r1 + 0.5 * r2
    return torch.as_tensor(a.reshape(nway), dtype=f.dtype, device=f.device)


def rnc_fctn(
    f: torch.Tensor,
    lam: float,
    omega: torch.Tensor,
    rank: np.ndarray | None = None,
    max_rank: np.ndarray | None = None,
    rho: float = 0.1,
    beta: float = 1.0,
    rh: float = 1.0,
    tol: float = 1e-6,
    max_iter: int = 100,
    origin: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    init=None,
    pad_values=None,
    device=None,
):
    """PAM robust FCTN completion of a 4-way tensor. omega True = observed.

    Returns (X, gs, E, rse_real_hist, n_iters). rank/max_rank are 4x4
    upper-triangular FCTN-rank matrices (defaults: all-2 growing to all-3).
    The random draws (the initial factors, and one padding scalar per rank
    growth) come from `generator` (a CPU generator, default seed 0) unless
    `init` (four factors) and `pad_values` (an iterable of floats, one
    consumed per growth) hand them in, as a parity test does.

    A tensor `f` keeps its device unless `device` names another; numpy goes
    to the card (`RuntimeError` without CUDA; `device="cpu"` for the plain
    path); `omega`, `origin` and `init` follow `f`."""
    f = solver_input(f, device=device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    nway = tuple(f.shape)
    if len(nway) != 4:
        raise ValueError("RNC-FCTN is defined for 4-way tensors")
    if rank is None:
        rank = np.triu(np.full((4, 4), 2), 1)
    if max_rank is None:
        max_rank = np.triu(np.full((4, 4), 3), 1)
    rank = np.asarray(rank)
    max_rank = np.asarray(max_rank)

    dtype, device = f.dtype, f.device
    origin = solver_input(origin, device=device)
    tempdim = _factor_dims(nway, rank)
    if init is None:
        gs = _init_factors(generator, nway, rank, dtype, device)
    else:
        gs = tuple(torch.as_tensor(g, dtype=dtype, device=device) for g in init)
    pad_values = iter(pad_values) if pad_values is not None else None
    max_tempdim = _factor_dims(nway, max_rank)
    x = f
    e = torch.zeros_like(f)
    y = f
    omega = torch.as_tensor(omega, device=device).to(torch.bool)
    r_change = 0.01
    hist = []
    norm_xt = float(torch.linalg.vector_norm(origin)) if origin is not None else 1.0
    k = 0
    for k in range(1, max_iter + 1):
        x, e, y, gs, rse = _pam_step(f, omega, x, e, y, gs, lam, rho, beta)
        rse = float(rse)
        if origin is not None:
            hist.append(float(torch.linalg.vector_norm(origin - x - e)) / norm_xt)
        if k > 10 and rse < tol:
            break
        # adaptive rank growth (`RNC_FCTN.m:88-93`): pad every growable bond
        rank_inc = (tempdim < max_tempdim).astype(int)
        if rse < r_change and rank_inc.sum() > 0:
            if pad_values is not None:
                pad_val = float(next(pad_values))
            else:
                pad_val = float(torch.rand((), generator=generator, dtype=dtype, device=generator.device))
            new_gs = []
            for i in range(4):
                # F.pad lists the last axis first
                pads = [p for j in reversed(range(4)) for p in (0, int(rank_inc[i, j]))]
                new_gs.append(torch.nn.functional.pad(gs[i], pads, value=pad_val))
            gs = tuple(new_gs)
            tempdim = tempdim + rank_inc
            r_change *= 0.5
        beta = rh * beta
    return x, gs, e, np.asarray(hist), k
