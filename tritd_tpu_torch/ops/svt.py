"""Singular-value thresholding (SVT) operators for the baseline suite.

PyTorch counterpart of `tritd_tpu/ops/svt.py`. The vendored baselines
(TT-TRPCA, RC-FCTN, RTRC) are all SVT-ADMMs. Two semantics exist in the
reference:

* ``svt``: standard; shrink singular values by tau, keep the > 0 ones
  (`other_methods/tensor-ring/shrink_matrix.m:27-32` else-branch).
* ``svt_ref_compat``: the TTNN/FCTN variant with the truncation quirk
  ``r = sum(S > 1)``; values in (0, 1] after shrinkage are ALSO dropped
  (`.../lib/TTNN/Functions/SVT.m:8`, `IPI_RTC_FCTN-main/lib/SVT.m:8`). Kept
  behind an explicit function because it changes results.

Routes (``method``), all reconstructing through the computed orthonormal
basis, so the output does not depend on the signs or the rotations inside
clusters that `torch.linalg` happens to return:

* ``"svd"`` (default): a thin SVD, backward-stable.
* ``"gram"``: eigh of the thin-side k x k Gram (k = min(p, q)) plus two
  GEMMs, never forming the long singular factor:

      SVT(M) = U f(s)/s U^T M        (p <= q, M M^T = U s^2 U^T)
      SVT(M) = M V f(s)/s V^T        (p > q,  M^T M = V s^2 V^T)

  The raw Gram eigenvalues carry absolute error ~eps * s_max^2, so their
  square roots have relative error ~eps * (s_max/s)^2. Therefore s is NOT
  taken from them: it is recovered from the row/column norms of the
  projection (U^T M or M V), which the reconstruction needs anyway and whose
  relative error is ~eps * s_max/s, the first-power law of a stable SVD.
  The eigh basis still mixes components whose s^2 lie within ~eps * s_max^2
  of each other; that rotation cancels in the reconstruction except where
  the shrinkage weight f(s)/s varies across such a cluster, i.e. near the
  threshold for components with s <~ sqrt(eps) * s_max.
* ``"lowrank[:budget]"``: randomized subspace iteration for the square-ish
  bipartitions of the RC-FCTN video protocol (4800x4800, 3600x6400,
  `video_triple_comparison.m:209-224` at subdim 20), where the Gram trick
  still leaves a large eigh. Valid only for tail-truncating shrinkage, see
  :func:`_lowrank_apply`.
* ``"auto[:budget]"``: ``"gram"`` below LOWRANK_MIN_DIM on the thin side,
  ``"lowrank:<budget>"`` from there on.
* ``"warm[:K]"`` (parsed by :func:`warm_spec`, run by the solvers through
  :func:`run_warm_blocks`): exact Gram-eigh every K-th iteration, the stale
  basis in between.

The routing constants keep the reference's values: they decide which route
runs, and so what the result is.

On a CUDA tensor every eigh and SVD goes through :mod:`.device_linalg`
(cuSOLVER with its `info` left on the card, and the hand-written Jacobi
SVD: a CUDA graph can capture an eigh up to n = 512 and an SVD up to a thin
side of `device_linalg.SVD_JACOBI_MAX_K`, no larger one, and :func:`captures`
tells a loop which routes and shapes a graph can hold); on the CPU through
`torch.linalg`, as before. The randomized route's QRs stay
`torch.linalg.qr`, which captures and replays bitwise.
A loop that runs an SVT route under a CUDA graph draws the randomized
route's sketch before the loop (:func:`_sketch_for`) and passes it in: the
sketch's generator cannot be captured.
"""

from __future__ import annotations

import torch

from . import device_linalg
from .kruskal import on_input_device
from .shrinkage import soft_threshold

#: Thin-side size from which :func:`auto_method` sends "auto" to the
#: randomized top-k path in place of the Gram eigh.
LOWRANK_MIN_DIM = 2048
#: Default rank budget of the randomized path.
LOWRANK_BUDGET = 1024
#: Seed of the randomized path's sketch; each shape folds its own offset in.
LOWRANK_SEED = 20260821


def captures(method: str, shapes) -> bool:
    """Whether a CUDA graph can capture the SVT route `method` on a matrix
    of each of `shapes`: the "svd" route where every SVD is of a shape
    `device_linalg.svd_captures` (the Jacobi SVD's; gesvdj past it reads
    back to the host), any other where its eighs (the thin side's Gram; the
    randomized route's budget x budget matrix) are all of a size
    `device_linalg.eigh_captures`. A loop that runs an SVT route asks
    before its capture (`baselines/device_loop.py::route`)."""
    if method == "svd":
        return all(device_linalg.svd_captures(*shape) for shape in shapes)
    for shape in shapes:
        side, resolved = min(shape), (method if method.startswith("warm") else _resolve(method, shape))
        if resolved.startswith("lowrank"):
            _, _, budget = resolved.partition(":")
            side = min(int(budget) if budget else LOWRANK_BUDGET, side)
        if not device_linalg.eigh_captures(side):
            return False
    return True


def auto_method(p: int, q: int, budget: int = LOWRANK_BUDGET) -> str:
    """Static, shape-based SVT routing: thin side < LOWRANK_MIN_DIM gives
    ``"gram"``, otherwise ``"lowrank:<budget>"``."""
    return "gram" if min(p, q) < LOWRANK_MIN_DIM else f"lowrank:{budget}"


def lowrank_sketch(p: int, q: int, b: int, dtype, device) -> torch.Tensor:
    """The (q, b) standard-normal sketch of a p x q matrix (p <= q), drawn
    from a generator seeded by the shape alone, so runs repeat. The
    reference draws its sketch from `jax.random.fold_in(PRNGKey(20260821),
    p*131071+q)`, whose numbers torch cannot reproduce."""
    gen = torch.Generator(device=device).manual_seed(LOWRANK_SEED + p * 131071 + q)
    return torch.randn((q, b), generator=gen, dtype=dtype, device=device)


def _ref_compat_shrink(tau):
    """soft(s, tau), then zero whatever is not above one."""
    def shrink(s):
        s_shrunk = soft_threshold(s, tau)
        return torch.where(s_shrunk > 1.0, s_shrunk, torch.zeros_like(s_shrunk))
    return shrink


def _plain_shrink(tau):
    return lambda s: torch.clamp(s - tau, min=0.0)


def _rescale(s: torch.Tensor, shrink) -> torch.Tensor:
    """f(s)/s, with s guarded against zero."""
    return shrink(s) / torch.clamp(s, min=torch.finfo(s.dtype).tiny)


def _lowrank_apply(m: torch.Tensor, shrink, budget: int, omega: torch.Tensor | None = None) -> torch.Tensor:
    """Top-`budget` spectral shrinkage by randomized subspace iteration:
    GEMMs, thin QRs and one budget x budget eigh; never a large eigh/SVD.

    Valid whenever `shrink` zeroes the spectrum below the captured range:
    then the *exact* operator output is itself rank-limited and the range
    finder only needs to capture every component the operator keeps. The
    ref-compat `>1` gate guarantees this as long as the retained rank
    (#{s > tau+1}) fits the budget; plain soft-thresholding qualifies only
    when tau exceeds the (budget+1)-th singular value. Components beyond the
    budget are dropped. `omega` replaces the (q, b) sketch of the wide
    orientation (q = the long side), for tests that inject another draw."""
    p, q = m.shape
    if p > q:
        return _lowrank_apply(m.T, shrink, budget, omega).T
    b = min(budget, p)
    if omega is None:
        omega = lowrank_sketch(p, q, b, m.dtype, m.device)
    y = m @ omega
    # Two power passes with Householder-QR re-orthonormalization between
    # passes (CholQR would square the iterate's condition number, which the
    # power iteration makes astronomically large).
    for _ in range(2):
        y = torch.linalg.qr(y)[0]
        y = m @ (m.T @ y)
    qmat = torch.linalg.qr(y)[0]                     # p x b orthonormal range
    bmat = qmat.T @ m                                # b x q
    _, u_hat = device_linalg.eigh(bmat @ bmat.T)     # b x b
    proj = u_hat.T @ bmat                            # rows are s_i * v_i^T
    s = torch.sqrt(torch.sum(proj * proj, dim=1))    # refined s (see gram path)
    return (qmat @ (u_hat * _rescale(s, shrink)[None, :])) @ proj


def _resolve(method: str, shape) -> str:
    """An "auto[:budget]" route resolved for a matrix of `shape`; any other
    route as it is."""
    if method == "auto" or method.startswith("auto:"):
        _, _, budget = method.partition(":")
        return auto_method(*shape, **({"budget": int(budget)} if budget else {}))
    return method


def _sketch_for(shape, method: str, dtype, device) -> torch.Tensor | None:
    """The sketch the randomized route draws for a matrix of `shape` (the
    same numbers, `lowrank_sketch`), or None where `method` does not
    resolve to that route there."""
    method = _resolve(method, shape)
    if not method.startswith("lowrank"):
        return None
    _, _, budget = method.partition(":")
    p, q = sorted(shape)
    return lowrank_sketch(p, q, min(int(budget) if budget else LOWRANK_BUDGET, p), dtype, device)


def _apply_spectral(m: torch.Tensor, shrink, method: str, truncating: bool = False,
                    omega: torch.Tensor | None = None) -> torch.Tensor:
    """Reconstruct with shrunk singular values: shrink(s) maps the singular
    values to their replacements (zeros drop the component). `truncating`
    declares that `shrink` zeroes the tail of the spectrum (the ref-compat
    `>1` gate), the validity condition of the lowrank route; plain
    soft-thresholding keeps every s > tau, so the route would silently drop
    surviving tail components. `omega`: the randomized route's sketch,
    drawn by the caller (:func:`_sketch_for`)."""
    method = _resolve(method, m.shape)
    if method == "svd":
        u, s, vt = device_linalg.svd(m)
        return (u * shrink(s)[None, :]) @ vt
    if method.startswith("lowrank"):
        if not truncating:
            raise ValueError(
                "the 'lowrank'/'auto' randomized SVT route is only valid for"
                " tail-truncating shrinkage (svt_ref_compat's >1 gate); plain"
                " svt() would silently drop components the operator keeps at"
                f" shape {tuple(m.shape)}. Use method='gram' or 'svd', or call"
                " svt_ref_compat."
            )
        _, _, budget = method.partition(":")
        return _lowrank_apply(m, shrink, int(budget) if budget else LOWRANK_BUDGET, omega)
    if method != "gram":
        raise ValueError(
            f"unknown SVT method {method!r}; use 'gram', 'svd',"
            " 'auto[:budget]', or 'lowrank[:budget]'"
        )
    p, q = m.shape
    if p <= q:
        _, u = device_linalg.eigh(m @ m.T)
        proj = u.T @ m  # rows are s_i * v_i^T for the computed basis
        s = torch.sqrt(torch.sum(proj * proj, dim=1))  # refined s, module docstring
        return (u * _rescale(s, shrink)[None, :]) @ proj
    _, v = device_linalg.eigh(m.T @ m)
    proj = m @ v  # columns are s_i * u_i for the computed basis
    s = torch.sqrt(torch.sum(proj * proj, dim=0))
    return proj @ (v.T * _rescale(s, shrink)[:, None])


@on_input_device("m")
def svt(m: torch.Tensor, tau, method: str = "svd") -> torch.Tensor:
    """Standard singular-value soft-thresholding: U max(S - tau, 0) V^T.

    Rejects the 'lowrank' route (and 'auto' when it resolves to lowrank):
    without a tail-truncating gate the randomized path is invalid; it would
    silently drop every surviving component beyond its budget. 'auto' stays
    usable for the thin unfoldings that resolve to 'gram' (all the RTRC
    benchmark shapes do)."""
    return _apply_spectral(m, _plain_shrink(tau), method)


#: Thin-side size from which the "warm:<K>" route carries a basis for an
#: unfolding; below it the Gram eigh runs every iteration.
WARM_MIN_DIM = 128


def warm_spec(svt_method: str, mat_shapes) -> tuple[int, tuple[int, ...], tuple[int, ...]]:
    """Parse ``"warm:<K>"`` against a solver's list of unfolding shapes into
    (refresh period K, indices of unfoldings that carry a warm basis, their
    thin-side sizes). Unfoldings with thin side < WARM_MIN_DIM run the
    exact gram path every iteration.

    Strict form: exactly ``"warm"`` (default K=4) or ``"warm:<int>"``; a
    typo like ``"warm8"`` must error, not silently run a different refresh
    schedule than the one recorded and validated."""
    name, sep, k = svt_method.partition(":")
    if name != "warm" or (sep and not k.isdigit()) or (sep and int(k) < 1):
        raise ValueError(
            f"malformed warm SVT method {svt_method!r}: use 'warm' or"
            " 'warm:<K>' with integer K >= 1 (e.g. 'warm:8')"
        )
    period = int(k) if k else 4
    idx, thin = [], []
    for i, (p, q) in enumerate(mat_shapes):
        t = min(p, q)
        if t >= WARM_MIN_DIM:
            idx.append(i)
            thin.append(t)
    return period, tuple(idx), tuple(thin)


def run_warm_blocks(body, carry, k0: int, n_steps: int, period: int):
    """Drive `body(k, carry, refresh: bool)` for `n_steps` iterations from
    absolute iteration `k0`, refreshing on the first iteration of every
    `period`-block counted from `k0`, the remainder block included. A caller
    that chunks its iterations starts a new block with each chunk, so with
    chunks of 25 and period 8 the refreshes fall at offsets 0, 8, 16 and 24
    of each chunk: `k % period == 0` on the absolute k is another schedule."""
    for j, refresh in enumerate(_refresh_schedule(n_steps, period)):
        carry = body(k0 + j, carry, refresh)
    return carry


def _refresh_schedule(n_steps: int, period: int) -> list[bool]:
    """Whether each of `n_steps` iterations of one block refreshes
    (:func:`run_warm_blocks`'s schedule)."""
    return [j % period == 0 for j in range(n_steps)]


def _warm_apply(m, shrink, basis, refresh_now: bool):
    """Shared warm-basis spectral shrinkage: exact thin-side Gram eigh on
    refresh, stale-basis projection otherwise. Returns (out, basis)."""
    p, q = m.shape
    if p < q:
        out, basis = _warm_apply(m.T, shrink, basis, refresh_now)
        return out.T, basis
    v = device_linalg.eigh(m.T @ m)[1] if refresh_now else basis
    proj = m @ v  # columns are s_i * u_i when v is current
    s = torch.sqrt(torch.sum(proj * proj, dim=0))
    return proj @ (v.T * _rescale(s, shrink)[:, None]), v


@on_input_device("m", "basis")
def svt_warm(m: torch.Tensor, tau, basis: torch.Tensor, refresh_now: bool):
    """Plain soft-threshold SVT with a warm-started basis, the RTRC
    (`shrink_matrix.m` flag=false branch) analog of
    :func:`svt_ref_compat_warm`. Unlike the randomized 'lowrank' route,
    warm reuse needs NO truncating gate: it approximates the basis, not the
    retained rank, so it is valid for any shrinkage; its accuracy is the
    empirical basis-drift question that `tools/validate_warm_svt.py` answers
    per shape."""
    return _warm_apply(m, _plain_shrink(tau), basis, refresh_now)


@on_input_device("m", "basis")
def svt_ref_compat_warm(m: torch.Tensor, tau, basis: torch.Tensor, refresh_now: bool):
    """Ref-compat SVT with a WARM-STARTED spectral basis.

    Where the `>1` gate keeps most of the spectrum (chicago's 5929x2016
    RC-FCTN bipartition keeps >= 76%), the randomized top-k route is invalid
    and the exact route pays a thin-side eigh every iteration. But the ADMM
    iterate drifts slowly, so the singular BASIS barely moves between
    iterations. This routes:

    * on `refresh_now`: exact Gram-eigh of the thin side, as method="gram";
    * otherwise: REUSE `basis` (the thin-side singular basis from the last
      refresh): one projection GEMM `m @ V`, refined s from the
      projection's column norms (exact if V were current; Rayleigh-quotient
      estimates under drift), shrink, reconstruct.

    Returns ``(svt_output, basis)``; thread `basis` through the solver's
    carry. `basis` is the thin-side orthonormal basis (q x q when p >= q,
    else p x p); initialize with identity: callers must refresh on the
    first iteration (run_warm_blocks does)."""
    return _warm_apply(m, _ref_compat_shrink(tau), basis, refresh_now)


@on_input_device("m")
def svt_ref_compat(m: torch.Tensor, tau, method: str = "svd", *, omega: torch.Tensor | None = None) -> torch.Tensor:
    """SVT with the reference's ``r = sum(soft(S,tau) > 1)`` truncation quirk
    (`TTNN/Functions/SVT.m:5-12`): shrunken values <= 1 are zeroed entirely.

    The reference slices the rank-r head of the descending spectrum; zeroing
    every shrunken value <= 1 is order-independent and equivalent. `omega`:
    the randomized route's sketch, drawn by a caller that runs this under a
    CUDA graph (:func:`_sketch_for`, before its loop)."""
    return _apply_spectral(m, _ref_compat_shrink(tau), method, truncating=True, omega=omega)
