"""Classic CP / Tucker decomposition algorithms — the Tensor Toolbox v3.1
algorithm surface (`cp_als.m`, `tucker_als.m`, `hosvd.m`): `mttkrp`,
`cp_als`, `tucker_hosvd`, `tucker_ttm`, `tucker_hooi`.

PyTorch counterpart of `tritd_tpu/ops/decomp.py`: N-way generic, the same
update equations, stopping rules and returned dict keys. What differs:

* The reference's `lax.while_loop` bodies run in Python loops here, with one
  host read of the fit change per iteration. The condition
  `(it < max_iters) and (delta >= tol)` is tested before each body with
  `delta = inf` at entry, so `max_iters = 0` returns the init with
  `fit = -inf`. `n_iters` is a Python int, `fit` a 0-d tensor.
* Contraction orders are written out as two-operand steps (the reference
  leaves them to an einsum path optimizer): `mttkrp` contracts the tensor
  with the largest of the other factors in one GEMM, then folds each
  remaining factor into the (…, R) intermediate; `tucker_ttm` is a chain of
  single-mode products, most-shrinking mode first. The Khatri-Rao product
  never materializes and nothing depends on what is installed. Results agree
  with the reference to rounding, not bitwise.
* The Gram solve is `cholesky_ex` + `cholesky_solve` with the reference's
  jitter `32 eps (trace(G)/R + 1)`; a failed factorization gives NaN factors
  (as `jax.scipy.linalg.cho_factor` does) instead of raising.
* Bases (`_leading_basis`, HOSVD/HOOI factors) are unique up to sign and,
  at tied eigenvalues, rotation: compare projectors or reconstructions.
"""

from __future__ import annotations

import math

import torch

from .kruskal import cp_normalize, default_generator, draw


def mttkrp(x: torch.Tensor, factors, mode: int) -> torch.Tensor:
    """Matricized-tensor times Khatri-Rao product for the given mode
    (Tensor Toolbox `mttkrp`): out[i_mode, r] = sum over the other indices of
    x[...] * prod_{ax != mode} factors[ax][i_ax, r], in O(prod n_i * R)
    operations without the Khatri-Rao matrix."""
    n = x.ndim
    others = [ax for ax in range(n) if ax != mode]
    first = max(others, key=lambda ax: x.shape[ax])
    # one GEMM over the largest other mode: that axis goes, R is appended
    y = torch.tensordot(x, factors[first], dims=([first], [0]))
    axes = [ax for ax in range(n) if ax != first]
    for ax in sorted((a for a in others if a != first), reverse=True):
        pos = axes.index(ax)
        u = factors[ax]
        view = [1] * y.ndim
        view[pos], view[-1] = u.shape[0], u.shape[1]
        y = (y * u.reshape(view)).sum(dim=pos)
        axes.pop(pos)
    return y


def _hadamard_gram(factors, skip: int | None = None) -> torch.Tensor:
    """Hadamard product of the factors' R x R Grams, leaving out mode `skip`
    (`cp_als.m` "Y = prod(UtU(:,:,[1:n-1,n+1:N]),3)")."""
    g = None
    for ax, u in enumerate(factors):
        if ax == skip:
            continue
        gram = u.T @ u
        g = gram if g is None else g * gram
    return g


def _spd_solve_rows(g: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """rows = rhs @ inv(G + jitter I) for a Gram G (R x R) and rhs (n, R).

    The jitter is scale-relative and above the dtype's eps, so overcomplete
    ranks (R > n_mode, singular Gram) stay finite. `cholesky_ex` does not
    read `info` back to the host; a failed factorization is turned into NaN
    on the device, the reference's behaviour."""
    rank = g.shape[0]
    eps = torch.finfo(g.dtype).eps
    jitter = 32 * eps * (torch.trace(g) / rank + 1.0)
    eye = torch.eye(rank, dtype=g.dtype, device=g.device)
    low, info = torch.linalg.cholesky_ex(g + jitter * eye)
    low = torch.where(info > 0, torch.full_like(low, math.nan), low)
    return torch.cholesky_solve(rhs.T, low).T


def _kruskal_fit(norm_x, factors, inner) -> torch.Tensor:
    """fit = 1 - ||X - full||/||X|| without `full`: ||full||^2 = 1^T
    (hadamard of Grams) 1 and `inner` = <X, full>."""
    norm_full_sq = _hadamard_gram(factors).sum()
    resid_sq = torch.clamp(norm_x**2 + norm_full_sq - 2.0 * inner, min=0.0)
    return 1.0 - torch.sqrt(resid_sq) / norm_x


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _cp_als_run(x, factors0, rank: int, max_iters: int, tol: float):
    n = x.ndim
    norm_x = torch.linalg.vector_norm(x)
    factors = list(factors0)
    fit = _scalar(-math.inf, x)
    delta, it = math.inf, 0
    while it < max_iters and delta >= tol:
        for mode in range(n):
            rhs = mttkrp(x, factors, mode)  # (n_mode, R)
            factors[mode] = _spd_solve_rows(_hadamard_gram(factors, mode), rhs)
        inner = (mttkrp(x, factors, n - 1) * factors[n - 1]).sum()
        new_fit = _kruskal_fit(norm_x, factors, inner)
        delta = float(torch.abs(new_fit - fit))
        fit = new_fit
        it += 1
    return factors, fit, it


def cp_als(
    x: torch.Tensor,
    rank: int,
    max_iters: int = 50,
    tol: float = 1e-4,
    generator: torch.Generator | None = None,
    init_factors=None,
    init: str = "random",
):
    """CP decomposition by alternating least squares (`cp_als.m` semantics:
    per-mode MTTKRP + Hadamard-Gram solve, fit-change stop).

    init: "random" (uniform factors — the toolbox default; seed-sensitive,
    can stall in local optima exactly as the original does) or "nvecs"
    (per-mode leading singular bases, the toolbox's deterministic option —
    recommended; columns beyond n_mode are padded with random normals for
    overcomplete ranks).

    Returns dict with `weights`, `factors` (column-normalized), `fit`
    (1 - relative error), `n_iters`.
    """
    if init_factors is None:
        generator = default_generator(generator)
        if init == "nvecs":
            init_factors = []
            for mode, s in enumerate(x.shape):
                u = _leading_basis(x, mode, min(rank, s))
                if rank > s:
                    pad = draw("normal", generator, (s, rank - s), x.dtype, x.device)
                    u = torch.cat([u, pad], dim=1)
                init_factors.append(u.to(x.dtype))
        elif init == "random":
            init_factors = [
                draw("uniform", generator, (s, rank), x.dtype, x.device) for s in x.shape
            ]
        else:
            raise ValueError(f'init must be "random" or "nvecs", got {init!r}')
    factors, fit, iters = _cp_als_run(x, init_factors, rank, max_iters, tol)
    factors, weights = cp_normalize(factors)
    return {
        "weights": weights,
        "factors": factors,
        "fit": fit,
        "n_iters": iters,
    }


def _leading_basis(x: torch.Tensor, mode: int, rank: int) -> torch.Tensor:
    """Top-`rank` left singular vectors of unfold(x, mode), via eigh on the
    (n_mode, n_mode) Gram (no SVD of the fat unfolding)."""
    xm = x.movedim(mode, 0).reshape(x.shape[mode], -1)
    _w, v = torch.linalg.eigh(xm @ xm.T)  # ascending eigenvalues
    return v.flip(1)[:, :rank]


def tucker_hosvd(x: torch.Tensor, ranks) -> dict:
    """Truncated higher-order SVD (`hosvd.m` semantics): per-mode leading
    left-singular basis, core = X times_n U_n^T."""
    ranks = tuple(ranks)
    factors = [_leading_basis(x, m, r) for m, r in enumerate(ranks)]
    core = tucker_ttm(x, factors, transpose=True)
    return {"core": core, "factors": factors}


def _mode_product(x: torch.Tensor, u: torch.Tensor, mode: int, transpose: bool) -> torch.Tensor:
    """X times_mode U (or U^T): one GEMM over mode `mode`, which is replaced."""
    if transpose:
        u = u.T
    out = torch.tensordot(u, x, dims=([1], [mode]))
    return out.movedim(0, mode)


def tucker_ttm(x: torch.Tensor, factors, transpose: bool = False) -> torch.Tensor:
    """Multilinear product X times_n U_n (or U_n^T) over all modes —
    Tensor Toolbox `ttm(X, U, 'all')`. A chain of single-mode products, the
    mode that shrinks the tensor most first. A `None` in `factors` leaves
    that mode as it is (the reference passes an identity there)."""

    def growth(ax):
        u = factors[ax]
        n_out, n_in = (u.shape[1], u.shape[0]) if transpose else (u.shape[0], u.shape[1])
        return n_out / n_in

    modes = [ax for ax, u in enumerate(factors) if u is not None]
    for ax in sorted(modes, key=growth):
        x = _mode_product(x, factors[ax], ax, transpose)
    return x


def _hooi_run(x, factors0, ranks, max_iters: int, tol: float):
    n = x.ndim
    norm_x = torch.linalg.vector_norm(x)
    factors = list(factors0)
    fit = _scalar(-math.inf, x)
    delta, it = math.inf, 0
    while it < max_iters and delta >= tol:
        for mode in range(n):
            # Project all other modes, then take the leading basis of the
            # result's mode unfolding (`tucker_als.m` core iteration).
            proj = [factors[ax] if ax != mode else None for ax in range(n)]
            y = tucker_ttm(x, proj, transpose=True)
            factors[mode] = _leading_basis(y, mode, ranks[mode])
        core = tucker_ttm(x, factors, transpose=True)
        # ||X - [core; U]||^2 = ||X||^2 - ||core||^2 for orthonormal U.
        resid_sq = torch.clamp(norm_x**2 - (core**2).sum(), min=0.0)
        new_fit = 1.0 - torch.sqrt(resid_sq) / norm_x
        delta = float(torch.abs(new_fit - fit))
        fit = new_fit
        it += 1
    core = tucker_ttm(x, factors, transpose=True)
    return core, factors, fit, it


def tucker_hooi(
    x: torch.Tensor,
    ranks,
    max_iters: int = 50,
    tol: float = 1e-4,
) -> dict:
    """Tucker decomposition by HOOI (`tucker_als.m` semantics: HOSVD init,
    per-mode projected leading basis, fit-change stop)."""
    ranks = tuple(int(r) for r in ranks)
    init = tucker_hosvd(x, ranks)["factors"]
    core, factors, fit, iters = _hooi_run(x, init, ranks, max_iters, tol)
    return {
        "core": core,
        "factors": factors,
        "fit": fit,
        "n_iters": iters,
    }
