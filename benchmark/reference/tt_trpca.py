"""Plain TT-TRPCA ("TTNN"), written from the upstream baseline
`TT_TRPCA.m:1-77` with its `weightTC.m` weights and `SVT.m` shrinkage.

Weights: alpha_m = min(prod(n_1..n_m), prod(n_m+1..n_N)), normalised to sum 1;
beta_m = f alpha_m. Per iteration k, with gamma_k = gamma 1.1^k and
delta_k = delta 1.1^k:

    U_m = SVT(unfold_m(Z - C_m / beta_m), alpha_m / beta_m)   (each TT unfolding)
    Y   = soft(S - J / delta, lambda / delta)
    (Z, S) solve the joint 2x2 system of `TT_TRPCA.m:53-62`
    C_m += beta_m (U_m - Z);  E += gamma (X_noisy - Z - S);  J += delta (Y - S)
    err[k] = ||X - Z|| / ||X||

SVT keeps `SVT.m`'s truncation: the singular values are shrunk by tau, and
those left at 1 or below are dropped. The SVD is `torch.linalg.svd` in
`dtype`; with `tf32` the SVD's input and the product that rebuilds the
matrix are rounded to TF32 (the benchmark's control). The loop runs all
`iterations` (the upstream skips its tolerance test). Imports nothing of the
program.
"""

from __future__ import annotations

import math

import torch

from .precision import matmul, round_tf32


def _weights(shape) -> list[float]:
    n = len(shape)
    raw = [min(math.prod(shape[: m + 1]), math.prod(shape[m + 1:])) for m in range(n - 1)]
    return [w / sum(raw) for w in raw]


def svt(mat: torch.Tensor, tau: float, tf32: bool = False) -> torch.Tensor:
    if tf32:
        mat = round_tf32(mat.float())
    u, s, vh = torch.linalg.svd(mat, full_matrices=False)
    s = torch.clamp(s - tau, min=0.0)
    s = torch.where(s > 1.0, s, torch.zeros_like(s))
    return matmul(u * s, vh, tf32)


def solve(y: torch.Tensor, preset: dict, iterations: int, origin: torch.Tensor | None = None,
          dtype: torch.dtype = torch.float64, tf32: bool = False) -> dict:
    """Runs TT-TRPCA on the observed tensor `y`; returns Z, S and the history."""
    shape = tuple(y.shape)
    lam, f, gamma, delta = preset["lam"], preset["f"], preset["gamma"], preset["deta"]
    alpha = _weights(shape)
    beta = [f * a for a in alpha]
    rows = [math.prod(shape[: m + 1]) for m in range(len(shape) - 1)]
    y = y.to(dtype)
    x = origin.to(dtype) if origin is not None else None
    z = torch.zeros_like(y)
    s = torch.zeros_like(y)
    e = torch.zeros_like(y)
    j = torch.zeros_like(y)
    cs = [torch.zeros_like(y) for _ in rows]
    err = torch.full((iterations,), float("nan"), dtype=dtype, device=y.device)
    for k in range(iterations):
        gam, det = gamma * 1.1**k, delta * 1.1**k
        us = [svt((z - cs[m] / beta[m]).reshape(rows[m], -1), alpha[m] / beta[m], tf32).reshape(shape)
              for m in range(len(rows))]
        v = s - j / det
        yy = torch.sign(v) * torch.clamp(torch.abs(v) - lam / det, min=0.0)
        temp = sum(beta[m] * (us[m] + cs[m] / beta[m]) for m in range(len(rows)))
        data = gam * (y + e / gam)
        ee = temp + data
        ff = data + det * (yy + j / det)
        tt = gam**2 - (sum(beta) + gam) * (gam + det)
        z = (gam * ff - (gam + det) * ee) / tt
        s = (gam * ee - (sum(beta) + gam) * ff) / tt
        cs = [cs[m] + beta[m] * (us[m] - z) for m in range(len(rows))]
        e = e + gam * (y - z - s)
        j = j + det * (yy - s)
        if x is not None:
            err[k] = torch.linalg.vector_norm(x - z) / torch.linalg.vector_norm(x)
    return {"z": z, "s": s, "err_hist": err}
