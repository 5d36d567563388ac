"""TriTD design matrices and triple-product reconstruction.

PyTorch counterpart of `tritd_tpu/ops/designs.py`. Two contraction
semantics:

* **hadamard** (every exercised reference path,
  `fast_robust_triple_tensor/triple_decomp_ADMM.m:132-160`):

      L[i,j,t] = sum_{q,s} A[i,q,s] B[q,j,s] C[q,s,t]

* **full** (Qi et al. 2021, `origin_triple_tensor/build{F,G,H}.m:4-11`):

      L[i,j,t] = sum_{p,q,s} A[i,q,s] B[p,j,s] C[p,q,t]

Index conventions follow :mod:`tritd_tpu_torch.ops.fold`. The solver never
materializes F/G/H (see :mod:`tritd_tpu_torch.ops.normal_eq`); the
materializers are the test oracle.
"""

from __future__ import annotations

import torch

VARIANTS = ("hadamard", "full")


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")


def build_f(b: torch.Tensor, c: torch.Tensor, variant: str = "hadamard") -> torch.Tensor:
    """Design matrix for the mode-1 (A) update, shape (r*r, n3*n2); columns
    ordered (t major, j minor) to match ``unfold(X, 1)``."""
    _check_variant(variant)
    r, n2, _ = b.shape
    n3 = c.shape[2]
    if variant == "hadamard":
        f4 = torch.einsum("qjs,qst->qstj", b, c)
    else:
        f4 = torch.einsum("pjs,pqt->qstj", b, c)
    return f4.reshape(r * r, n3 * n2)


def build_g(a: torch.Tensor, c: torch.Tensor, variant: str = "hadamard") -> torch.Tensor:
    """Design matrix for the mode-2 (B) update, shape (r*r, n3*n1)."""
    _check_variant(variant)
    n1, r, _ = a.shape
    n3 = c.shape[2]
    if variant == "hadamard":
        g4 = torch.einsum("ips,pst->psti", a, c)
    else:
        g4 = torch.einsum("iqs,pqt->psti", a, c)
    return g4.reshape(r * r, n3 * n1)


def build_h(a: torch.Tensor, b: torch.Tensor, variant: str = "hadamard") -> torch.Tensor:
    """Design matrix for the mode-3 (C) update, shape (r*r, n2*n1)."""
    _check_variant(variant)
    n1, r, _ = a.shape
    n2 = b.shape[1]
    if variant == "hadamard":
        h4 = torch.einsum("ipq,pjq->pqji", a, b)
    else:
        h4 = torch.einsum("iqs,pjs->pqji", a, b)
    return h4.reshape(r * r, n2 * n1)


def triple_product(
    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, variant: str = "hadamard"
) -> torch.Tensor:
    """Reconstruction L = TriTD(A, B, C), shape (n1, n2, n3).

    One (n1, r^2) x (r^2, n2*n3) GEMM after an r^2-scale pre-contraction
    W[(q,s), (j,t)], whose (j, t) column order lets the product reshape
    straight to (n1, n2, n3)."""
    _check_variant(variant)
    n1, r, _ = a.shape
    n2 = b.shape[1]
    n3 = c.shape[2]
    if variant == "hadamard":
        # W[(q,s), (j,t)] = B[q,j,s] * C[q,s,t]
        w = torch.einsum("qjs,qst->qsjt", b, c)
    else:
        # W[(q,s), (j,t)] = sum_p B[p,j,s] C[p,q,t]
        w = torch.einsum("pjs,pqt->qsjt", b, c)
    l1 = torch.matmul(a.reshape(n1, r * r), w.reshape(r * r, n2 * n3))
    return l1.reshape(n1, n2, n3)


def triple_product_naive(
    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, variant: str = "hadamard"
) -> torch.Tensor:
    """Direct einsum oracle for tests (spec: the quadruple loops in
    `fast_robust_triple_tensor/buildF.m:5-16`)."""
    _check_variant(variant)
    if variant == "hadamard":
        return torch.einsum("iqs,qjs,qst->ijt", a, b, c)
    return torch.einsum("iqs,pjs,pqt->ijt", a, b, c)


def kron_f(b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Explicit-Kronecker baseline for the full variant
    (`origin_triple_tensor/kronF.m:4-6`): the same matrix as
    ``build_f(b, c, "full")``, F[(q,s),(t,j)] = sum_p B[p,j,s] C[p,q,t]."""
    r, n2, _ = b.shape
    n3 = c.shape[2]
    bm = b.permute(2, 1, 0).reshape(r * n2, r)  # [(s,j), p]
    cm = c.reshape(r, r * n3)  # [p, (q,t)]
    f = (bm @ cm).reshape(r, n2, r, n3)  # [s, j, q, t]
    return f.permute(2, 0, 3, 1).reshape(r * r, n3 * n2)


def kron_g(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Explicit-Kronecker counterpart of ``build_g(a, c, "full")``
    (`origin_triple_tensor/kronG.m`): G[(p,s),(t,i)] = sum_q A[i,q,s] C[p,q,t]."""
    n1, r, _ = a.shape
    n3 = c.shape[2]
    am = a.permute(2, 0, 1).reshape(r * n1, r)  # [(s,i), q]
    cm = c.permute(1, 0, 2).reshape(r, r * n3)  # [q, (p,t)]
    g = (am @ cm).reshape(r, n1, r, n3)  # [s, i, p, t]
    return g.permute(2, 0, 3, 1).reshape(r * r, n3 * n1)


def kron_h(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Explicit-Kronecker counterpart of ``build_h(a, b, "full")``
    (`origin_triple_tensor/kronH.m`): H[(p,q),(j,i)] = sum_s A[i,q,s] B[p,j,s]."""
    n1, r, _ = a.shape
    n2 = b.shape[1]
    am = a.permute(1, 0, 2).reshape(r * n1, r)  # [(q,i), s]
    bm = b.permute(2, 0, 1).reshape(r, r * n2)  # [s, (p,j)]
    h = (am @ bm).reshape(r, n1, r, n2)  # [q, i, p, j]
    return h.permute(2, 0, 3, 1).reshape(r * r, n2 * n1)
