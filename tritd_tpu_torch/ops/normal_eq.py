"""Kronecker-free normal equations for the TriTD mode updates.

PyTorch counterpart of `tritd_tpu/ops/normal_eq.py`. The Grams factorize, so
the designs F/G/H never exist (hadamard variant):

    F F^T = GramB (.) GramC     G G^T = GramA (.) GramC     H H^T = GramA (.) GramB

Right-hand sides (hadamard):

    rhs_1[i,(q,s)] = sum_{j,t} X[i,j,t] B[q,j,s] C[q,s,t]
    rhs_2[j,(p,s)] = sum_{i,t} X[i,j,t] A[i,p,s] C[p,s,t]
    rhs_3[t,(p,q)] = sum_{i,j} X[i,j,t] A[i,p,q] B[p,j,q]

The reference writes each as one three-operand einsum and lets XLA pick the
order. Here each is written out, so that no einsum path optimizer is needed:
one O(n1 n2 n3 r^2) `torch.matmul` over an n-sized index of X (the last
index t for mode 1, the first index i for modes 2 and 3, so X is read in
place), then an O(n^2 r^2) (hadamard) or O(n^2 r^3) (full) two-operand
contraction with the remaining core. Accumulation stays in the factor dtype,
so a float64 run is float64 throughout.

With `einsum_dtype` (bfloat16, float16, float8_e4m3fn or float8_e5m2), as
in the reference (`tritd_tpu/ops/normal_eq.py:150-163`), X and the cores
are rounded to it (`narrow.narrow_cast`, the reference's rounding), the
contraction accumulates in float32 and the result comes back in the factor
dtype; the Grams and the solves stay full precision. The form taken is a
float32 GEMM on the rounded operands widened to float32: the product of two
bf16, float16 or float8 significands (8, 11, 4 or 3 bits) is exact in
float32, so this is the reference's einsum with
`preferred_element_type=float32`. A narrow `torch.matmul` would round its
output to the narrow dtype, which is not the reference. It needs TF32 off
on CUDA (PyTorch's default for matmul).
"""

from __future__ import annotations

import torch

from .designs import _check_variant
from .narrow import narrow_cast

SOLVE_METHODS = ("cholesky", "pinv", "lstsq")


def gram_a(a: torch.Tensor) -> torch.Tensor:
    """GramA[(p,q),(p',q')] = sum_i A[i,p,q] A[i,p',q'] — (r^2, r^2)."""
    n1, r, _ = a.shape
    af = a.reshape(n1, r * r)
    return af.T @ af


def gram_b(b: torch.Tensor) -> torch.Tensor:
    """GramB[(q,s),(q',s')] = sum_j B[q,j,s] B[q',j,s'] — (r^2, r^2)."""
    r, n2, _ = b.shape
    bm = b.permute(0, 2, 1).reshape(r * r, n2)
    return bm @ bm.T


def gram_c(c: torch.Tensor) -> torch.Tensor:
    """GramC[(q,s),(q',s')] = sum_t C[q,s,t] C[q',s',t] — (r^2, r^2)."""
    r, _, n3 = c.shape
    cm = c.reshape(r * r, n3)
    return cm @ cm.T


def combine_grams(
    mode: int,
    ga: torch.Tensor | None,
    gb: torch.Tensor | None,
    gc: torch.Tensor | None,
    variant: str = "hadamard",
) -> torch.Tensor:
    """Combine the core Grams into the mode's normal-equation matrix."""
    _check_variant(variant)
    if mode not in (1, 2, 3):
        raise ValueError(f"mode must be 1, 2 or 3, got {mode}")
    if variant == "hadamard":
        return {1: lambda: gb * gc, 2: lambda: ga * gc, 3: lambda: ga * gb}[mode]()
    some = ga if ga is not None else gb
    r = int(round(some.shape[0] ** 0.5))
    ga4 = ga.reshape(r, r, r, r) if ga is not None else None  # [q,s,q',s']
    gb4 = gb.reshape(r, r, r, r) if gb is not None else None  # [p,s,p',s']
    gc4 = gc.reshape(r, r, r, r) if gc is not None else None  # [p,q,p',q']
    if mode == 1:
        k = torch.einsum("psPS,pqPQ->qsQS", gb4, gc4)
    elif mode == 2:
        k = torch.einsum("qsQS,pqPQ->psPS", ga4, gc4)
    else:
        k = torch.einsum("qsQS,psPS->pqPQ", ga4, gb4)
    return k.reshape(r * r, r * r)


def gram_mode(
    mode: int,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    variant: str = "hadamard",
) -> torch.Tensor:
    """K = F F^T (mode 1) / G G^T (mode 2) / H H^T (mode 3) without ever
    materializing the design matrix."""
    ga = gram_a(a) if mode in (2, 3) else None
    gb = gram_b(b) if mode in (1, 3) else None
    gc = gram_c(c) if mode in (1, 2) else None
    return combine_grams(mode, ga, gb, gc, variant)


def rhs_mode(
    mode: int,
    x: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    variant: str = "hadamard",
    einsum_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Right-hand side unfold(X, mode) @ design^T, shape (n_mode, r^2), in
    the factor dtype."""
    _check_variant(variant)
    if mode not in (1, 2, 3):
        raise ValueError(f"mode must be 1, 2 or 3, got {mode}")
    if einsum_dtype is not None:
        out_dtype = a.dtype
        x, a, b, c = (narrow_cast(u, einsum_dtype).to(torch.float32) for u in (x, a, b, c))
        return _rhs(mode, x, a, b, c, variant).to(out_dtype)
    return _rhs(mode, x.to(a.dtype), a, b, c, variant)


def _rhs(mode, x, a, b, c, variant):
    n1, n2, n3 = x.shape
    r = a.shape[1]
    rr = r * r
    if mode == 1:
        # Y[i,j,(p,q)] = sum_t X[i,j,t] C[p,q,t]: GEMM over t
        y = torch.matmul(x.reshape(n1 * n2, n3), c.reshape(rr, n3).T)
        if variant == "hadamard":
            # rhs[i,(q,s)] = sum_j Y[i,j,(q,s)] B[q,j,s]
            bm = b.permute(0, 2, 1).reshape(rr, n2)
            rhs = torch.einsum("ijk,kj->ik", y.reshape(n1, n2, rr), bm)
        else:
            # rhs[i,q,s] = sum_{j,p} Y[i,j,p,q] B[p,j,s]
            rhs = torch.einsum("ijpq,pjs->iqs", y.reshape(n1, n2, r, r), b)
        return rhs.reshape(n1, rr)
    # Y[j,t,(p,q)] = sum_i X[i,j,t] A[i,p,q]: GEMM over i (X^T is a view)
    y = torch.matmul(x.reshape(n1, n2 * n3).T, a.reshape(n1, rr))
    if mode == 2:
        if variant == "hadamard":
            # rhs[j,(p,s)] = sum_t Y[j,t,(p,s)] C[p,s,t]
            rhs = torch.einsum("jtk,kt->jk", y.reshape(n2, n3, rr), c.reshape(rr, n3))
        else:
            # rhs[j,p,s] = sum_{t,q} Y[j,t,q,s] C[p,q,t]
            rhs = torch.einsum("jtqs,pqt->jps", y.reshape(n2, n3, r, r), c)
        return rhs.reshape(n2, rr)
    if variant == "hadamard":
        # rhs[t,(p,q)] = sum_j Y[j,t,(p,q)] B[p,j,q]
        bm = b.permute(0, 2, 1).reshape(rr, n2)
        rhs = torch.einsum("jtk,kj->tk", y.reshape(n2, n3, rr), bm)
    else:
        # rhs[t,p,q] = sum_{j,s} Y[j,t,q,s] B[p,j,s]
        rhs = torch.einsum("jtqs,pjs->tpq", y.reshape(n2, n3, r, r), b)
    return rhs.reshape(n3, rr)


def gram_and_rhs(
    mode: int,
    x: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    variant: str = "hadamard",
    einsum_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, rhs) for the ridge system of the given mode update."""
    return (
        gram_mode(mode, a, b, c, variant=variant),
        rhs_mode(mode, x, a, b, c, variant=variant, einsum_dtype=einsum_dtype),
    )


def ridge_solve(
    k: torch.Tensor, rhs: torch.Tensor, alpha: float, method: str = "cholesky"
) -> torch.Tensor:
    """Solve rows @ (K + alpha I) = rhs for rows, i.e. rhs @ inv(K + alpha I).

    K is SPD (a Gram). `cholesky_ex` is used, not `cholesky`: the latter
    reads `info` back to the host on every call. Like the reference's
    `cho_factor`, a failed factorization is not checked; it shows as
    non-finite factors and residuals."""
    m = k.shape[0]
    kr = k + alpha * torch.eye(m, dtype=k.dtype, device=k.device)
    if method == "cholesky":
        low, _info = torch.linalg.cholesky_ex(kr)
        return torch.cholesky_solve(rhs.T, low).T
    if method == "pinv":
        # jnp.linalg.pinv's cutoff: 10 * max(m, n) * eps of the dtype
        rtol = 10.0 * m * torch.finfo(k.dtype).eps
        return rhs @ torch.linalg.pinv(kr, rtol=rtol)
    if method == "lstsq":
        return torch.linalg.lstsq(kr, rhs.T).solution.T
    raise ValueError(f"method must be one of {SOLVE_METHODS}, got {method!r}")
