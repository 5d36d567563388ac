"""TT-TRPCA ("TTNN"): tensor-train nuclear-norm robust PCA by ADMM.

PyTorch counterpart of `tritd_tpu/baselines/ttnn.py`. Reference:
`other_methods/Low-rank-tensor-train-for-tensor-robust-principal-
component-analysis-master/lib/TT_TRPCA.m:1-77`, with `weightTC.m` balanced
weights and the `SVT.m` truncation quirk (kept, see
:func:`tritd_tpu_torch.ops.svt.svt_ref_compat`).

Per iteration: SVT on each of the N-1 sequential TT unfoldings of Z,
l1-shrink the sparse clone Y, closed-form joint (Z, S) solve, dual ascent,
1.1x penalty growth. Driver preset: lambda=50, f=5, gamma=1e-3, deta=2e-3
(`traffic_triple_comparison.m:116-120`).

The unfoldings are row-major reshapes; SVT is invariant under the
consistent row/column permutation relating them to MATLAB's column-major
reshapes, so results are identical. The loop runs on the device of the
input, through `baselines/device_loop.py`: on the CPU a host loop; on the
card one CUDA graph replay an iteration (two graphs with `warm:K`, refresh
and reuse), the penalties a table computed on the host before the loop and
read by the device's counter, the histories written at the counter, and no
read to the host before the loop's end (the SVT's eigh and SVD through
`ops/device_linalg.py`); the eager loop where no graph captures the SVT
route at these unfoldings (`device_loop.route`: an SVD of a thin side past
`device_linalg.SVD_JACOBI_MAX_K`, an eigh past n = 512).
"""

from __future__ import annotations

import math

import torch

from ..ops.kruskal import solver_input
from ..ops.shrinkage import soft_threshold
from ..ops.svt import svt_ref_compat, svt_ref_compat_warm, warm_spec
from . import device_loop
from .device_loop import Scalars, write
from .penalty import grown_penalty


def weight_tc(nway: tuple[int, ...]) -> list[float]:
    """Balanced TT weights alpha_n = min(dimL, dimR) / sum (`weightTC.m`)."""
    n = len(nway)
    il = nway[0]
    lam = []
    for k in range(n - 1):
        ir = math.prod(nway[k + 1:])
        lam.append(min(il, ir))
        il *= nway[k + 1]
    total = sum(lam)
    return [v / total for v in lam]


def tt_trpca(
    x_noise: torch.Tensor,
    lam: float = 50.0,
    f: float = 5.0,
    gamma: float = 0.001,
    deta: float = 0.002,
    origin: torch.Tensor | None = None,
    max_iter: int = 100,
    svt_method: str = "svd",
    device=None,
):
    """Returns (Z low-rank, S sparse, errHist vs origin, n_iters). The
    reference runs the full 100 iterations (its tol check is bypassed,
    `TT_TRPCA.m:40`). ``svt_method`` picks the SVT route (see ops/svt.py),
    ``"warm:<K>"`` included: basis reuse on the TT cuts whose thin side
    reaches WARM_MIN_DIM, exact gram on the others. A tensor `x_noise` keeps
    its device unless `device` names another; numpy goes to the card
    (`RuntimeError` without CUDA; `device="cpu"` for the plain path);
    `origin` follows it."""
    x_noise = solver_input(x_noise, device=device)
    origin = solver_input(origin, device=x_noise.device)
    nway = tuple(x_noise.shape)
    ncuts = len(nway) - 1
    alpha = weight_tc(nway)
    beta = [f * a for a in alpha]
    sum_beta = sum(beta)
    dim_l = [math.prod(nway[: m + 1]) for m in range(ncuts)]
    total = math.prod(nway)

    dtype, device = x_noise.dtype, x_noise.device
    zeros = torch.zeros_like(x_noise)
    norm_origin = torch.linalg.vector_norm(origin) if origin is not None else None
    shapes = [(d, total // d) for d in dim_l]
    warm = svt_method.startswith("warm")
    warm_period, warm_idx, warm_thin = None, (), ()
    if warm:
        warm_period, warm_idx, warm_thin = warm_spec(svt_method, shapes)

    def penalties(k: int) -> dict:
        # the penalties grow in the run's dtype, as the reference's do; the
        # other scalars are the host's double arithmetic on them
        gam = grown_penalty(gamma, 1.1, k, dtype)
        det = grown_penalty(deta, 1.1, k, dtype)
        return {"gam": gam, "det": det, "lam_det": lam / det, "gam_det": gam + det, "beta_gam": sum_beta + gam,
                "tt": gam**2 - (sum_beta + gam) * (gam + det)}

    scalars = Scalars([penalties(k) for k in range(max_iter)], dtype, device)
    err_hist = torch.full((max_iter,), float("nan"), dtype=dtype, device=device)
    rel_hist = err_hist.clone()

    def step(k, c: dict, refresh) -> dict:
        z, s, e, j = c["z"], c["s"], c["e"], c["j"]
        cs = [c[f"c{m}"] for m in range(ncuts)]
        new = {}
        # U_n: SVT on each sequential TT unfolding (`TT_TRPCA.m:45-48`)
        us = []
        for m in range(ncuts):
            mat = (z - cs[m] / beta[m]).reshape(dim_l[m], -1)
            if m in warm_idx:
                w = warm_idx.index(m)
                mat, new[f"b{w}"] = svt_ref_compat_warm(mat, alpha[m] / beta[m], c[f"b{w}"], refresh)
            else:
                mat = svt_ref_compat(mat, alpha[m] / beta[m], method="gram" if warm else svt_method)
            us.append(mat.reshape(nway))
        sc = scalars.at(k)
        gam, det = sc["gam"], sc["det"]
        # Y: l1 shrink of the sparse clone (`:51`)
        y = soft_threshold(s - j / det, sc["lam_det"])
        # closed-form joint (Z, S) solve (`:53-62`)
        temp = sum(beta[m] * (us[m] + cs[m] / beta[m]) for m in range(ncuts))
        data = gam * (x_noise + e / gam)
        ee = temp + data
        ff = data + det * (y + j / det)
        z_new = (gam * ff - sc["gam_det"] * ee) / sc["tt"]
        s_new = (gam * ee - sc["beta_gam"] * ff) / sc["tt"]
        # dual ascent (`:64-70`)
        for m in range(ncuts):
            new[f"c{m}"] = cs[m] + beta[m] * (us[m] - z_new)
        new["e"] = e + gam * (x_noise - z_new - s_new)
        new["j"] = j + det * (y - s_new)
        write(rel_hist, k, torch.linalg.vector_norm(z_new - z) / (torch.linalg.vector_norm(z) + 1e-30))
        if origin is not None:
            write(err_hist, k, torch.linalg.vector_norm(origin - z_new) / norm_origin)
        return {**new, "z": z_new, "s": s_new}

    carry = {"z": zeros, "s": zeros, "e": zeros, "j": zeros, **{f"c{m}": zeros for m in range(ncuts)},
             **{f"b{w}": torch.eye(t, dtype=dtype, device=device) for w, t in enumerate(warm_thin)}}
    carry = device_loop.run(step, carry, device_loop.schedule(max_iter, max_iter, warm_period), [max_iter],
                            device_loop.route(device, svt_method, shapes))
    return carry["z"], carry["s"], err_hist, max_iter
