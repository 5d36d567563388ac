"""RC-FCTN: robust tensor completion via the Fully-Connected Tensor
Network nuclear-norm surrogate, by ADMM.

PyTorch counterpart of `tritd_tpu/baselines/rc_fctn.py`. Reference:
`other_methods/IPI_RTC_FCTN-main/RTC_FCTN/RC_FCTN.m:1-117`: SVT over all
C(N, N/2)/2 balanced mode bipartitions (`myorder` `:119-136`, `weightFCTN`
`:138-150` with max(IL, IR) weights), l1 sparse part, closed-form joint
(X, E), observed-entry projection of Y (`:92`), 1.5x penalty growth,
RSE_real oracle history. The SVT carries the reference's `r = sum(S > 1)`
truncation quirk (`lib/SVT.m:8`).

Driver wrappers reproduce the two protocols:
  * traffic (`traffic_triple_comparison.m:149-173`): 3-way -> 4-way reshape
    [I, J, K/sub, sub], Ind = all-ones (the driver's `Ind(~mask)=1` on a
    ones array marks EVERYTHING observed, a quirk kept for parity),
    lambda = 5000/sqrt(max(I,J)*n3*n4), f=0.1, gamma=deta=1e-3.
  * video (`video_triple_comparison.m:240-262`): [I, J, sub, K/sub],
    Ind = observed indicator, lambda=1.8, f=0.7.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ..ops.kruskal import solver_input
from ..ops.shrinkage import prox_l1
from ..ops.svt import _sketch_for, svt_ref_compat, svt_ref_compat_warm, warm_spec
from . import device_loop
from .device_loop import Scalars, write
from .penalty import grown_penalty


def _bipartition_shapes(nway, dims_l):
    total = math.prod(nway)
    return [(d, total // d) for d in dims_l]


#: Rank budget of the randomized SVT for the video bipartition shapes
#: (4800x4800, 3600x6400 at subdim 20), the value the reference validated
#: against its exact path; `tools/validate_lowrank_svt.py` repeats that
#: validation for this package.
VIDEO_SVT_BUDGET = 512


def resolve_video_svt_method(svt_method: str) -> str:
    """Resolve the video driver's SVT route: a bare "auto" gets the
    shape-validated budget (see VIDEO_SVT_BUDGET); every explicit request
    ("svd", "gram", "auto:<b>", "lowrank:<b>") passes through untouched: an
    explicit 'gram' must actually run the Gram path, and recorded metadata
    must name the route that ran."""
    return f"auto:{VIDEO_SVT_BUDGET}" if svt_method == "auto" else svt_method


def balanced_bipartitions(n: int):
    """`myorder(N)`: orders [combo, complement] over the unique balanced
    bipartitions (combos containing mode 0, lexicographic)."""
    half = n // 2
    orders = []
    for combo in itertools.combinations(range(n), half):
        if combo[0] != 0:
            continue
        rest = tuple(i for i in range(n) if i not in combo)
        orders.append(combo + rest)
    return orders


def weight_fctn(nway: tuple[int, ...], orders) -> list[float]:
    """`weightFCTN`: alpha_k = max(prod(first half), prod(second half)),
    normalized."""
    half = len(nway) // 2
    lam = []
    for order in orders:
        il = math.prod(nway[o] for o in order[:half])
        ir = math.prod(nway[o] for o in order[half:])
        lam.append(max(il, ir))
    total = sum(lam)
    return [v / total for v in lam]


def _rc_fctn_step(x_noise, ind_obs, origin, err_hist, lam, f, gamma0, deta0, max_iter, svt_method="svd",
                  warm_cfg=None):
    """The loop's `step(k, carry, refresh)` (`baselines/device_loop.py`)
    over the carry fields x, y, e, s, p, q, z<i> (one a bipartition) and
    b<j> (one a warm basis), writing RSE_real into `err_hist` at k. The
    penalties of iterations 0..max_iter-1 are a table computed here, and the
    randomized route's sketches are drawn here, before the loop."""
    nway = tuple(x_noise.shape)
    n = len(nway)
    half = n // 2
    orders = balanced_bipartitions(n)
    inv_orders = [tuple(int(v) for v in np.argsort(o)) for o in orders]
    alpha = weight_fctn(nway, orders)
    mu = [f * a for a in alpha]
    sum_mu = sum(mu)
    dims_l = [math.prod(nway[o] for o in order[:half]) for order in orders]
    total = math.prod(nway)

    dtype, device = x_noise.dtype, x_noise.device
    ind_mis = 1.0 - ind_obs
    norm_origin = torch.linalg.vector_norm(origin) if origin is not None else None
    # warm_cfg is the (period, indices, thin_sides) spec computed ONCE in
    # rc_fctn(), the same object that sized the carried bases, so index and
    # shape alignment cannot drift between the two.
    warm_idx = warm_cfg[1] if warm_cfg is not None else ()
    method = "gram" if warm_cfg is not None else svt_method
    omegas = [_sketch_for((d, total // d), method, dtype, device) for d in dims_l]

    def penalties(k: int) -> dict:
        gamma = grown_penalty(gamma0, 1.5, k, dtype)
        deta = grown_penalty(deta0, 1.5, k, dtype)
        return {"gamma": gamma, "deta": deta, "lam_deta": lam / deta, "gamma_deta": gamma + deta,
                "mu_gamma": sum_mu + gamma, "tt": gamma**2 - (sum_mu + gamma) * (gamma + deta)}

    scalars = Scalars([penalties(k) for k in range(max_iter)], dtype, device)

    def step(k, c: dict, refresh) -> dict:
        x, y, e, p, q = c["x"], c["y"], c["e"], c["p"], c["q"]
        zs = [c[f"z{i}"] for i in range(len(orders))]
        sc = scalars.at(k)
        gamma, deta = sc["gamma"], sc["deta"]
        new = {}
        # L_n: SVT over each balanced bipartition (`RC_FCTN.m:68-75`)
        ls = []
        for i, order in enumerate(orders):
            mat = (x - zs[i] / mu[i]).permute(order).reshape(dims_l[i], -1)
            if i in warm_idx:
                j = warm_idx.index(i)
                mat, new[f"b{j}"] = svt_ref_compat_warm(mat, alpha[i] / mu[i], c[f"b{j}"], refresh)
            else:
                mat = svt_ref_compat(mat, alpha[i] / mu[i], method=method, omega=omegas[i])
            shp = tuple(nway[o] for o in order)
            ls.append(mat.reshape(shp).permute(inv_orders[i]))
        # S (`:78`)
        s = prox_l1(e - q / deta, sc["lam_deta"])
        # joint (X, E) (`:81-89`)
        temp = sum(mu[i] * (ls[i] + zs[i] / mu[i]) for i in range(len(orders)))
        data = gamma * (y + p / gamma)
        m_ = temp + data
        n_ = data + deta * (s + q / deta)
        x = (gamma * n_ - sc["gamma_deta"] * m_) / sc["tt"]
        e = (gamma * m_ - sc["mu_gamma"] * n_) / sc["tt"]
        # observed-entry projection (`:92`)
        y = ind_mis * (x + e - p / gamma) + ind_obs * x_noise
        # duals (`:95-99`)
        for i in range(len(orders)):
            new[f"z{i}"] = zs[i] + mu[i] * (ls[i] - x)
        p = p + gamma * (y - x - e)
        q = q + deta * (s - e)
        if origin is not None:
            write(err_hist, k, torch.linalg.vector_norm(x + s - origin) / norm_origin)
        return {**new, "x": x, "y": y, "e": e, "s": s, "p": p, "q": q}

    return step


def rc_fctn(
    x_noise: torch.Tensor,
    lam: float,
    ind_obs: torch.Tensor,
    origin: torch.Tensor | None = None,
    f: float = 0.1,
    gamma: float = 1e-3,
    deta: float = 1e-3,
    max_iter: int = 100,
    svt_method: str = "svd",
    chunk: int | None = None,
    device=None,
):
    """Returns (X low-rank, S sparse, errHist RSE_real). ind_obs is the
    observed indicator (1 = keep data constraint). `chunk` splits the
    iterations into blocks of that many (None = one block), as the
    reference's dispatches do; it changes the result only in warm mode,
    where every block starts with a refresh.

    svt_method additionally accepts ``"warm:<K>"``: exact Gram-eigh SVT
    refreshed every K-th iteration, warm-started basis reuse in between,
    on bipartitions with thin side >= ops/svt.py WARM_MIN_DIM (others run
    exact gram every iteration): the route for shapes where the retained
    spectrum is NOT low-rank (chicago's 5929x2016 keeps >= 76%). Its
    agreement with the exact path is checked by
    `tools/validate_warm_svt.py`.

    A tensor `x_noise` keeps its device unless `device` names another;
    numpy goes to the card (`RuntimeError` without CUDA; `device="cpu"` for
    the plain path); `ind_obs` and `origin` follow it."""
    x_noise = solver_input(x_noise, device=device)
    ind = solver_input(ind_obs, x_noise.dtype, x_noise.device)
    origin = solver_input(origin, device=x_noise.device)
    chunk = max(1, max_iter if chunk is None else min(chunk, max_iter))
    dtype, dev = x_noise.dtype, x_noise.device
    zeros = torch.zeros_like(x_noise)
    orders = balanced_bipartitions(x_noise.ndim)
    half = x_noise.ndim // 2
    dims_l = [math.prod(x_noise.shape[o] for o in order[:half]) for order in orders]
    shapes = _bipartition_shapes(tuple(x_noise.shape), dims_l)
    bases, warm_cfg = {}, None
    if svt_method.startswith("warm"):
        warm_cfg = warm_spec(svt_method, shapes)
        # Identity placeholders; the first iteration of a block refreshes
        # before any reuse. Sized by the SAME spec object the steps consume.
        bases = {f"b{j}": torch.eye(t, dtype=dtype, device=dev) for j, t in enumerate(warm_cfg[2])}
    err_hist = torch.full((max_iter,), float("nan"), dtype=dtype, device=dev)
    step = _rc_fctn_step(x_noise, ind, origin, err_hist, float(lam), float(f), float(gamma), float(deta), max_iter,
                         svt_method, warm_cfg)
    carry = {"x": zeros, "y": x_noise, "e": zeros, "s": zeros, "p": zeros, "q": zeros,
             **{f"z{i}": zeros for i in range(len(orders))}, **bases}
    # one loop for the whole call, advanced chunk by chunk (one read of the
    # device's counter each); each chunk starts a new refresh block
    kinds = device_loop.schedule(max_iter, chunk, warm_cfg[0] if warm_cfg else None)
    carry = device_loop.run(step, carry, kinds, range(chunk, max_iter + chunk, chunk),
                            device_loop.route(dev, svt_method, shapes))
    return carry["x"], carry["s"], err_hist


def _split_mode3(x: torch.Tensor, n3: int, n4: int) -> torch.Tensor:
    """MATLAB column-major `reshape(X, [I J n3 n4])` of an (I, J, n3*n4)
    tensor: the third index is the FAST one within the original mode-3 axis.
    Row-major equivalent: split as (n4, n3) then swap."""
    i, j, _ = x.shape
    return x.reshape(i, j, n4, n3).permute(0, 1, 3, 2).contiguous()


def _merge_mode3(x4: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_split_mode3`."""
    i, j, n3, n4 = x4.shape
    return x4.permute(0, 1, 3, 2).reshape(i, j, n3 * n4)


def rc_fctn_driver_traffic(
    y: torch.Tensor,
    mask_obs: torch.Tensor,
    subdim: int,
    origin: torch.Tensor | None = None,
    max_iter: int = 100,
    svt_method: str = "svd",
    device=None,
):
    """Traffic-driver wrapper (`traffic_triple_comparison.m:149-173`):
    4-way reshape [I, J, K/sub, sub] (column-major semantics). `mask_obs`
    is not used: the driver marks everything observed. `y` and `origin` are
    placed as in :func:`rc_fctn`."""
    y = solver_input(y, device=device)
    origin = solver_input(origin, device=y.device)
    i, j, k = y.shape
    n3, n4 = k // subdim, subdim
    y4 = _split_mode3(y, n3, n4)
    origin4 = _split_mode3(origin, n3, n4) if origin is not None else None
    lam = 5000.0 / math.sqrt(max(i, j) * n3 * n4)
    ind = torch.ones_like(y4)  # driver quirk: everything marked observed
    # warm route: chunk=25 is the configuration the reference validated
    x4, s4, err_hist = rc_fctn(
        y4, lam, ind, origin=origin4, f=0.1, max_iter=max_iter,
        svt_method=svt_method,
        chunk=25 if svt_method.startswith("warm") else None,
    )
    return _merge_mode3(x4), _merge_mode3(s4), err_hist


def rc_fctn_driver_video(
    y: torch.Tensor,
    mask_obs: torch.Tensor,
    subdim: int,
    origin: torch.Tensor | None = None,
    max_iter: int = 100,
    svt_method: str = "auto",
    device=None,
):
    """Video-driver wrapper (`video_triple_comparison.m:240-262`):
    4-way reshape [I, J, sub, K/sub] (column-major semantics).

    Default svt_method="auto": the video bipartitions are square-ish
    (4800x4800, 3600x6400 at subdim 20), where the Gram trick still leaves
    a large eigh per bipartition per iteration. "auto" routes those (and
    only those: thin side >= ops/svt.py LOWRANK_MIN_DIM) to the randomized
    top-k SVT at VIDEO_SVT_BUDGET. Every explicit request, including
    "gram", runs exactly the route it names (resolve_video_svt_method).
    `y`, `mask_obs` and `origin` are placed as in :func:`rc_fctn`."""
    y = solver_input(y, device=device)
    origin = solver_input(origin, device=y.device)
    i, j, k = y.shape
    n3, n4 = subdim, k // subdim
    y4 = _split_mode3(y, n3, n4)
    origin4 = _split_mode3(origin, n3, n4) if origin is not None else None
    ind = _split_mode3(solver_input(mask_obs, y.dtype, y.device), n3, n4)
    svt_method = resolve_video_svt_method(svt_method)
    x4, s4, err_hist = rc_fctn(
        y4, 1.8, ind, origin=origin4, f=0.7, max_iter=max_iter,
        svt_method=svt_method, chunk=25,
    )
    return _merge_mode3(x4), _merge_mode3(s4), err_hist
