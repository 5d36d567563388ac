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
input without a host read: the penalties are host scalars in the run's
dtype and the histories are device tensors written by index.
"""

from __future__ import annotations

import math

import torch

from ..ops.kruskal import solver_input
from ..ops.shrinkage import soft_threshold
from ..ops.svt import run_warm_blocks, svt_ref_compat, svt_ref_compat_warm, warm_spec
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
    warm = svt_method.startswith("warm")
    if warm:
        warm_period, warm_idx, warm_thin = warm_spec(svt_method, [(d, total // d) for d in dim_l])

    def body(k, carry, refresh=True):
        z, s, e, j, cs, bases, err_hist, rel_hist = carry
        # U_n: SVT on each sequential TT unfolding (`TT_TRPCA.m:45-48`)
        us = []
        bases_new = list(bases)
        for m in range(ncuts):
            mat = (z - cs[m] / beta[m]).reshape(dim_l[m], -1)
            if warm and m in warm_idx:
                w = warm_idx.index(m)
                mat, bases_new[w] = svt_ref_compat_warm(mat, alpha[m] / beta[m], bases[w], refresh)
            else:
                mat = svt_ref_compat(mat, alpha[m] / beta[m], method="gram" if warm else svt_method)
            us.append(mat.reshape(nway))
        # the penalties grow in the run's dtype, as the reference's do
        gam = grown_penalty(gamma, 1.1, k, dtype)
        det = grown_penalty(deta, 1.1, k, dtype)
        # Y: l1 shrink of the sparse clone (`:51`)
        y = soft_threshold(s - j / det, lam / det)
        # closed-form joint (Z, S) solve (`:53-62`)
        temp = sum(beta[m] * (us[m] + cs[m] / beta[m]) for m in range(ncuts))
        data = gam * (x_noise + e / gam)
        ee = temp + data
        ff = data + det * (y + j / det)
        tt = gam**2 - (sum_beta + gam) * (gam + det)
        z_new = (gam * ff - (gam + det) * ee) / tt
        s_new = (gam * ee - (sum_beta + gam) * ff) / tt
        # dual ascent (`:64-70`)
        cs_new = tuple(cs[m] + beta[m] * (us[m] - z_new) for m in range(ncuts))
        e = e + gam * (x_noise - z_new - s_new)
        j = j + det * (y - s_new)
        rel_hist[k] = torch.linalg.vector_norm(z_new - z) / (torch.linalg.vector_norm(z) + 1e-30)
        if origin is not None:
            err_hist[k] = torch.linalg.vector_norm(origin - z_new) / norm_origin
        return (z_new, s_new, e, j, cs_new, tuple(bases_new), err_hist, rel_hist)

    bases0 = tuple(torch.eye(t, dtype=dtype, device=device) for t in warm_thin) if warm else ()
    nan_hist = torch.full((max_iter,), float("nan"), dtype=dtype, device=device)
    carry = (zeros, zeros, zeros, zeros, tuple(zeros for _ in range(ncuts)), bases0,
             nan_hist, nan_hist.clone())
    if warm:
        carry = run_warm_blocks(body, carry, 0, max_iter, warm_period)
    else:
        for k in range(max_iter):
            carry = body(k, carry)
    z, s, _, _, _, _, err_hist, _ = carry
    return z, s, err_hist, max_iter
