"""RTRC: robust tensor-ring completion by ADMM ("RING"/TRLRF in the
reference's figures, `foreground_grid.m:66-67`).

PyTorch counterpart of `tritd_tpu/baselines/rtrc.py`. Reference:
`other_methods/tensor-ring/RTRC.m:1-83` with `shrink_matrix.m` (flag=false
-> plain SVT branch, which is what both drivers use), `shrink_vector.m`,
and the `evaluate_fr_R.m` freedom-ratio heuristic that sets the per-cut
weights from numerical ranks of the circular unfoldings.

Setup (host side): L = ceil(N/2) circular-shift unfoldings; lambda auto-set
from the sampling ratio (`RTRC.m:17-23`); weights 1/Em normalized
(`RTRC.m:33-35`). Loop (fixed 100 iterations, the reference's convergence
break is commented out, `RTRC.m:70-72`): SVT each circular unfolding,
masked data-fidelity x-update, l1 sparse part on observed entries, dual
ascent, mu*1.1 capped at 1e6. It runs through `baselines/device_loop.py`:
on the card one CUDA graph replay an iteration with no read to the host
before the end, mu and its quotients from a table computed on the host
(the eager loop where no graph captures the SVT, `device_loop.route`).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from ..ops.kruskal import solver_input
from ..ops.shrinkage import soft_threshold
from ..ops.svt import svt, svt_warm, warm_spec
from . import device_loop
from .device_loop import Scalars, write
from .penalty import grown_penalty


def _circular_orders(n: int):
    l = -(-n // 2)
    return [tuple(int(v) for v in (np.arange(n) + shift) % n) for shift in range(l)]


#: content-hash -> (FR, Em) cache. The numerical ranks are a pure function
#: of (x_obs, p_mask), and np.linalg.matrix_rank of the big circular
#: unfoldings is a host float64 SVD that dwarfs a repeated solve of the same
#: problem. Caching keeps EXACT numpy float64 rank semantics (a float32 rank
#: on the device would count near-tolerance singular values differently and
#: drift the weight trajectory against the reference emulator). Callers that
#: want the raw cost pass use_cache=False.
_FREEDOM_RATIO_CACHE: dict = {}


def _fingerprint(x_obs: torch.Tensor, p_mask: torch.Tensor) -> tuple:
    """Cheap content fingerprint of (x_obs, p_mask) for the rank cache:
    sha1 of a strided subsample (fewer than 80 samples along each axis, so
    only a small piece is fetched from the device), the Frobenius norm and the observed count. A
    false hit needs two different problems agreeing on all three, which is
    no realistic risk for repeated solves of one problem, the only pattern
    the cache serves."""
    strides = tuple(max(1, s // 40) for s in x_obs.shape)
    sl = tuple(slice(None, None, st) for st in strides)
    sample = x_obs[sl].to(torch.float32).cpu().numpy()
    h = hashlib.sha1(np.ascontiguousarray(sample).tobytes())
    norm = float(torch.linalg.vector_norm(x_obs))
    nobs = float(torch.sum(p_mask.to(torch.float32)))
    return (tuple(x_obs.shape), h.hexdigest(), round(norm, 4), nobs)


def freedom_ratio(x_obs, p_mask, use_cache: bool = True):
    """(FR, Em) per `evaluate_fr_R.m`: numerical rank of each circular
    unfolding of the observed tensor drives the weights and epsilon. The
    ranks are numpy float64 on the host."""
    x_obs, p_mask = torch.as_tensor(x_obs), torch.as_tensor(p_mask)
    key = None
    if use_cache:
        key = _fingerprint(x_obs, p_mask)
        hit = _FREEDOM_RATIO_CACHE.get(key)
        if hit is not None:
            return hit
    x_np = x_obs.cpu().numpy()
    n = x_np.ndim
    shape = x_np.shape
    m = p_mask.cpu().numpy().sum()
    l = -(-n // 2)
    df_m, em = [], []
    for order in _circular_orders(n):
        mat = np.transpose(x_np, order).reshape(math.prod([shape[o] for o in order[:l]]), -1)
        rank = np.linalg.matrix_rank(mat)
        big = max(mat.shape)
        df_m.append(rank * (sum(mat.shape) - rank) / m)
        em.append(big * rank * math.log(big) ** 2.5)
    out = (float(np.mean(df_m)), np.asarray(em, np.float64))
    if key is not None:
        if len(_FREEDOM_RATIO_CACHE) > 16:
            _FREEDOM_RATIO_CACHE.clear()
        _FREEDOM_RATIO_CACHE[key] = out
    return out


def _rtrc_run(x_obs, p, origin, mu0, lam, weights, orders, max_iter, svt_method="svd"):
    shape = tuple(x_obs.shape)
    l = len(orders)
    dtype, device = x_obs.dtype, x_obs.device
    zeros = torch.zeros_like(x_obs)
    norm_origin = torch.linalg.vector_norm(origin) if origin is not None else None
    inv_orders = [tuple(int(v) for v in np.argsort(o)) for o in orders]
    dims_l = [math.prod([shape[o] for o in order[: -(-len(shape) // 2)]]) for order in orders]
    total = math.prod(shape)
    shapes = [(d, total // d) for d in dims_l]
    warm = svt_method.startswith("warm")
    warm_period, warm_idx, warm_thin = None, (), ()
    if warm:
        # RTRC uses PLAIN soft-threshold SVT (no truncation gate), for which
        # warm reuse is valid: it approximates the basis, not the retained
        # rank (ops/svt.py::svt_warm).
        warm_period, warm_idx, warm_thin = warm_spec(svt_method, shapes)

    def penalties(i: int) -> dict:
        mu = grown_penalty(mu0, 1.1, i, dtype, cap=1e6)
        return {"mu": mu, "lam_mu": lam / mu, **{f"tau{n_}": weights[n_] / mu for n_ in range(l)}}

    scalars = Scalars([penalties(i) for i in range(max_iter)], dtype, device)
    err_hist = torch.full((max_iter,), float("nan"), dtype=dtype, device=device)

    def step(i, c: dict, refresh) -> dict:
        x, y, w = c["x"], c["y"], c["w"]
        zs = [c[f"z{n_}"] for n_ in range(l)]
        sc = scalars.at(i)
        mu = sc["mu"]
        new = {}
        # SVT each circular-shift unfolding (`RTRC.m:45-54`)
        ls_new = []
        for n_ in range(l):
            m = (x - zs[n_] / mu).permute(orders[n_]).reshape(dims_l[n_], -1)
            if n_ in warm_idx:
                wi = warm_idx.index(n_)
                m, new[f"b{wi}"] = svt_warm(m, sc[f"tau{n_}"], c[f"b{wi}"], refresh)
            else:
                m = svt(m, sc[f"tau{n_}"], method="gram" if warm else svt_method)
            shp = tuple(shape[o] for o in orders[n_])
            ls_new.append(m.reshape(shp).permute(inv_orders[n_]))
        l_cs = sum(ls_new)
        z_cs = sum(zs)
        # x update: masked data fidelity (`:56-58`)
        x = (l_cs + z_cs / mu + p * (x_obs - y - w / mu)) / (l + p)
        # y update: sparse part on observed entries (`:60`)
        y = soft_threshold(p * (x_obs - x - w / mu), sc["lam_mu"])
        # duals (`:62-66`)
        for n_ in range(l):
            new[f"z{n_}"] = zs[n_] + mu * (ls_new[n_] - x)
        w = w + mu * p * (x + y - x_obs)
        if origin is not None:
            write(err_hist, i, torch.linalg.vector_norm(x - origin) / norm_origin)
        return {**new, "x": x, "y": y, "w": w}

    carry = {"x": x_obs, "y": zeros, "w": zeros, **{f"z{n_}": zeros for n_ in range(l)},
             **{f"b{wi}": torch.eye(t, dtype=dtype, device=device) for wi, t in enumerate(warm_thin)}}
    carry = device_loop.run(step, carry, device_loop.schedule(max_iter, max_iter, warm_period), [max_iter],
                            device_loop.route(device, svt_method, shapes))
    return carry["x"], carry["y"], err_hist


def precompute_freedom_ratio(tnsr: torch.Tensor, p_mask: torch.Tensor, device=None):
    """Populate the freedom-ratio cache with EXACTLY the tensors a
    subsequent :func:`rtrc` call will fingerprint (same placement and dtype
    conversions), and return (FR, Em). Lets callers pay and report the
    host-SVD rank cost once, separately from the device solve."""
    tnsr = solver_input(tnsr, device=device)
    p_dev = solver_input(p_mask, tnsr.dtype, tnsr.device)
    return freedom_ratio(tnsr * p_dev, p_dev)


def rtrc(
    tnsr: torch.Tensor,
    p_mask: torch.Tensor,
    mu: float = 1e-1,
    origin: torch.Tensor | None = None,
    max_iter: int = 100,
    svt_method: str = "svd",
    device=None,
):
    """Returns (x low-rank, y sparse, errHist, n_iters).

    p_mask is the OBSERVED indicator (True = observed), like RTRC's P.
    Driver presets: mu=1e-1 traffic (`traffic_triple_comparison.m:139`),
    mu=1e-3 video with P all-true (`video_triple_comparison.m:156`).

    A tensor `tnsr` keeps its device unless `device` names another; numpy
    goes to the card (`RuntimeError` without CUDA; `device="cpu"` for the
    plain path); `p_mask` and `origin` follow it."""
    tnsr = solver_input(tnsr, device=device)
    origin = solver_input(origin, device=tnsr.device)
    n = tnsr.ndim
    l = -(-n // 2)
    shape = tuple(tnsr.shape)
    p_dev = solver_input(p_mask, tnsr.dtype, tnsr.device)
    x_obs = tnsr * p_dev

    sr = float(torch.sum(p_dev)) / p_dev.numel()
    lam = 0.0
    orders = _circular_orders(n)
    for order in orders:
        dim_l = math.prod([shape[o] for o in order[:l]])
        dim_r = math.prod([shape[o] for o in order[l:]])
        lam += 500.0 / math.sqrt(sr * max(dim_l, dim_r))

    _, em = freedom_ratio(x_obs, p_dev)
    weight = (1.0 / em) / (1.0 / em).sum()

    x, y, err_hist = _rtrc_run(
        x_obs, p_dev, origin, float(mu), float(lam), tuple(float(w) for w in weight),
        tuple(orders), max_iter, svt_method,
    )
    return x, y, err_hist, max_iter
