"""CP decomposition algorithm variants — the rest of the Tensor Toolbox v3.1
algorithm surface: ``cp_apr`` (Poisson multiplicative updates), ``cp_nmu``
(nonnegative Lee-Seung updates), ``cp_arls`` (randomized least squares),
``cp_opt`` / ``cp_wopt`` (direct / weighted optimization) and ``gcp_opt``
(generalized losses).

PyTorch counterpart of `tritd_tpu/ops/cp_variants.py`; the originals live at
``other_methods/tensor_toolbox-v3.1/{cp_apr,cp_nmu,cp_arls,cp_opt,cp_wopt,
gcp_opt}.m``. Shared across all of them:

* Khatri-Rao products are never materialized: the dense MTTKRP is
  `ops/decomp.py`'s; ``cp_arls`` gathers sampled factor rows (O(s·R)).
* The reference's `lax.while_loop`s of ``cp_nmu``, ``cp_apr``,
  ``cp_arls`` and ``gcp_opt`` are loops of `ops/toolbox_loop.py`: on a
  CUDA tensor one CUDA graph replay an iteration (``cp_apr``: an outer
  iteration, its `max_inner` inner sweeps unrolled in it as the reference's
  `fori_loop`), the stopping quantity, the counter and the flag on the
  card, the flag the one read to the host; on the CPU a host loop of the
  same iterations. The stop is tested before each body (`max_iters = 0`
  returns the init). `n_iters` is a Python int.
* ``gcp_opt`` uses `adam_descent` (`ops/symmetric.py`), optax's Adam
  recurrence written out, so from one init the two follow each other step
  for step. ``cp_opt``/``cp_wopt`` use this module's L-BFGS
  (`_lbfgs_fit`), built as the reference's optimizer is: ten pairs of
  memory, a first step capped to unit norm, and a zoom line search that
  takes Hager and Zhang's approximate decrease where the loss is flat to
  rounding. Without that rule (`torch.optim.LBFGS`'s strong Wolfe search)
  float32 stalls at the saddle near the 0.1·normal default init, where the
  first steps change a loss of about 1 by less than float32 resolves; the
  reference does not. The line searches still differ in their trial steps,
  so the two agree on loss and gradient at any point and on where they end,
  not on the path or on `n_iters`.
* Parameters are leaf tensors with `requires_grad`; every returned tensor
  is detached.
* ``cp_arls`` draws the sample indices of all `max_iters` iterations from
  `generator` before its loop, in the order the iterations use them, and
  each iteration reads its own by the device's counter; no argument can
  make it repeat the reference's draws, so the two are held to the same
  quality bar, and `arls_mode_solve` to a normal-equation solve on given
  indices.
"""

from __future__ import annotations

import math

import torch

from . import toolbox_loop
from .decomp import _factors_of, _fit_loop, _hadamard_gram, _kruskal_fit, _named, _spd_solve_rows, mttkrp
from .kruskal import cp_normalize, default_generator, draw, ktensor_full, on_input_device
from .symmetric import adam_descent


def _fit(x, factors, norm_x):
    """1 - ||X - [[U]]||/||X|| without materializing the full tensor."""
    inner = (mttkrp(x, factors, x.ndim - 1) * factors[-1]).sum()
    return _kruskal_fit(norm_x, factors, inner)


def _uniform_init(generator, x, rank):
    generator = default_generator(generator)
    return [draw("uniform", generator, (s, rank), x.dtype, x.device) for s in x.shape]


def _normal_init(generator, x, rank, scale=0.1):
    generator = default_generator(generator)
    return [scale * draw("normal", generator, (s, rank), x.dtype, x.device) for s in x.shape]


def _fit_change_loop(sweep, x, factors, max_iters, tol):
    """factors <- sweep(factors, k) until the fit changes by less than
    `tol` (`ops/decomp.py`'s `_fit_loop`)."""
    norm_x = torch.linalg.vector_norm(x)
    return _fit_loop(sweep, lambda fs: _fit(x, fs, norm_x), factors, x, max_iters, tol)


# ------------------------------------------------------------------- cp_nmu


@on_input_device("x", sequences=("init_factors",))
def cp_nmu(x, rank, max_iters=200, tol=1e-5, generator=None, init_factors=None):
    """Nonnegative CP by multiplicative updates — ``cp_nmu.m`` semantics
    (Lee-Seung step with an epsilon-guarded denominator, fit-change stop).
    Input must be elementwise nonnegative. Returns the same dict shape as
    `ops/decomp.py`'s `cp_als`."""
    if init_factors is None:
        init_factors = _uniform_init(generator, x, rank)
    eps = 1e-12

    def sweep(factors, _k):
        for mode in range(x.ndim):
            num = mttkrp(x, factors, mode)
            den = factors[mode] @ _hadamard_gram(factors, mode)
            # Lee-Seung multiplicative update (`cp_nmu.m` inner loop:
            # "B = B .* (mttkrp ./ (B * hadamard + eps))"), nonnegativity
            # preserved because the iterate and both terms are nonnegative.
            factors[mode] = factors[mode] * (num / (den + eps))
        return factors

    factors, fit, iters = _fit_change_loop(sweep, x, list(init_factors), max_iters, tol)
    factors, weights = cp_normalize(factors)
    return {"weights": weights, "factors": factors, "fit": fit, "n_iters": iters}


# ------------------------------------------------------------------- cp_apr


def _l1_normalize(u, eps):
    s = u.sum(dim=0)
    safe = torch.where(s > eps, s, torch.ones_like(s))
    return u / safe, torch.where(s > eps, s, torch.zeros_like(s))


@on_input_device("x", sequences=("init_factors",))
def cp_apr(x, rank, max_outer=100, max_inner=10, tol=1e-4, generator=None, init_factors=None):
    """Nonnegative CP for count data by Alternating Poisson Regression with
    multiplicative updates — ``cp_apr.m`` (default 'mu' method) semantics:
    per-mode inner MU sweeps ``B .*= MTTKRP(X ./ max(M, eps))``, KKT-violation
    stopping, Poisson log-likelihood reporting. Returns dict with `weights`,
    `factors`, `kkt_violation`, `log_likelihood`, `n_iters`."""
    if init_factors is None:
        init_factors = _uniform_init(generator, x, rank)
    n = x.ndim
    eps = 1e-10

    # Start from the toolbox's invariant: all factor columns l1-normalized,
    # magnitudes absorbed into the weight vector (`cp_apr.m` "M =
    # normalize(Minit,[],1)"). The l1 structure is what makes the KL
    # multiplicative update a fixed-point iteration: the implicit Khatri-Rao
    # of the OTHER modes then has unit column sums.
    factors = list(init_factors)
    lam = torch.ones((rank,), dtype=x.dtype, device=x.device)
    for ax in range(n):
        factors[ax], s = _l1_normalize(factors[ax], eps)
        lam = lam * s

    def phi_of(factors, b, mode):
        # Phi = (X_(n) ./ max(B Pi^T, eps)) Pi as one MTTKRP of the ratio
        # tensor (`cp_apr.m` "calculatePhi").
        fs = [b if ax == mode else factors[ax] for ax in range(n)]
        m = ktensor_full(fs)
        return mttkrp(x / torch.clamp(m, min=eps), fs, mode)

    def outer(c):
        # one outer iteration, its inner sweeps unrolled as the reference's
        # `fori_loop` (`tritd_tpu/ops/cp_variants.py:151`)
        factors, lam = _factors_of(c, n), c["lam"]
        kkt = toolbox_loop.full(0.0, x)
        for mode in range(n):
            # redistribute(M, n): absorb the weights into this mode's factor
            # (`cp_apr.m` "M = redistribute(M,n)").
            b = factors[mode] * lam[None, :]
            for _ in range(max_inner):
                b = b * phi_of(factors, b, mode)
            # KKT violation at the updated mode (`cp_apr.m`
            # "kktModeViolations(n) = max|min(B, 1 - Phi)|").
            phi = phi_of(factors, b, mode)
            kkt = torch.maximum(kkt, torch.amax(torch.abs(torch.minimum(b, 1.0 - phi))))
            # normalize(M,[],1,n): pull the column sums back into lambda.
            factors[mode], lam = _l1_normalize(b, eps)
        return {**_named(factors), "lam": lam, "kkt": kkt}, kkt

    carry = {**_named(map(toolbox_loop.fixed, factors)), "lam": toolbox_loop.fixed(lam),
             "kkt": toolbox_loop.full(math.inf, x)}
    carry, it = toolbox_loop.run(outer, carry, max_outer, tol)
    factors, lam, kkt = _factors_of(carry, n), carry["lam"], carry["kkt"]
    factors[0] = factors[0] * lam[None, :]
    # Poisson log-likelihood (`tt_loglikelihood.m`): sum(X .* log(M) - M).
    m = torch.clamp(ktensor_full(factors), min=eps)
    ll = (x * torch.log(m) - m).sum()
    factors, weights = cp_normalize(factors)
    return {
        "weights": weights,
        "factors": factors,
        "kkt_violation": kkt,
        "log_likelihood": ll,
        "n_iters": it,
    }


# ------------------------------------------------------------------ cp_arls


@on_input_device("x", sequences=("factors", "idx"))
def arls_mode_solve(x, factors, mode: int, idx) -> torch.Tensor:
    """One sampled least-squares solve of ``cp_arls``: the new factor of
    `mode` from the sampled multi-indices `idx` (one int64 (s,) tensor per
    other mode, in mode order). The sampled Khatri-Rao rows are the Hadamard
    product of gathered factor rows, the right-hand side the matching
    columns of unfold(x, mode); solved through the jittered s-sample Gram."""
    others = [ax for ax in range(x.ndim) if ax != mode]
    zs = factors[others[0]][idx[0]]
    for i, ax in zip(idx[1:], others[1:]):
        zs = zs * factors[ax][i]
    xs = x.movedim(mode, 0)[(slice(None), *idx)]  # (n_mode, s)
    return _spd_solve_rows(zs.T @ zs, xs @ zs)


@on_input_device("x", sequences=("init_factors",))
def cp_arls(x, rank, n_samples=None, max_iters=50, tol=1e-4, generator=None, init_factors=None):
    """CP by Alternating Randomized Least Squares — ``cp_arls.m`` semantics:
    each mode solve uses `n_samples` uniformly sampled rows of the implicit
    Khatri-Rao system (default 10·R·log(R+1), the toolbox's heuristic scale)
    instead of the full normal equations. The FJLT mixing step of the paper
    is omitted (the toolbox also defaults to ``'mix', false`` for dense
    inputs); sampling is with replacement."""
    generator = default_generator(generator)
    if n_samples is None:
        n_samples = max(int(10 * rank * math.log(rank + 1.0)), 4 * rank)
    n_samples = int(n_samples)
    if init_factors is None:
        init_factors = _uniform_init(generator, x, rank)

    # s multi-indices over the other modes for each mode of each iteration,
    # uniform with replacement (`cp_arls.m` "dense_sample_krp"), drawn in the
    # order the iterations use them, then copied to x's device at once
    n = x.ndim
    draws = torch.empty((max_iters, n, n - 1, n_samples), dtype=torch.int64, device=generator.device)
    for it in range(max_iters):
        for mode in range(n):
            for i, ax in enumerate(ax for ax in range(n) if ax != mode):
                draws[it, mode, i] = torch.randint(0, x.shape[ax], (n_samples,), generator=generator,
                                                   device=generator.device)
    draws = draws.to(x.device)

    def sweep(factors, k):
        idx = draws.index_select(0, k.view(1))[0]  # this iteration's, by the counter on the device
        for mode in range(n):
            factors[mode] = arls_mode_solve(x, factors, mode, list(idx[mode]))
        return factors

    factors, fit, iters = _fit_change_loop(sweep, x, list(init_factors), max_iters, tol)
    factors, weights = cp_normalize(factors)
    return {"weights": weights, "factors": factors, "fit": fit, "n_iters": iters}


# -------------------------------------------------------- cp_opt / cp_wopt


def _wolfe_step(value_grad, x, f0, g0, slope0, d, c1=1e-4, c2=0.9, approx_rtol=1e-6, max_evals=25):
    """A step t along `d` from `x` that meets the strong Wolfe curvature
    condition |φ'(t)| <= c2 |φ'(0)| and a decrease condition: Armijo's
    φ(t) <= φ(0) + c1 t φ'(0), or, where φ(t) <= φ(0) + approx_rtol |φ(0)|,
    Hager and Zhang's approximate one φ'(t) <= (1 - 2 c1) |φ'(0)|, which
    still reads a decrease that the loss itself is too flat to show.
    Bracketing doubles t, zooming bisects (Nocedal and Wright, Alg. 3.5/3.6).
    `f0` and `slope0` = φ'(0) are host floats; each trial reads φ and φ' to
    the host in one transfer, and nothing else. Returns (t, value,
    gradient); t = 0 when no step was found."""

    def trial(t):
        f, g = value_grad(x + t * d)
        f, slope = torch.stack([f, g @ d]).tolist()
        armijo = f <= f0 + c1 * t * slope0
        approx = f <= f0 + approx_rtol * abs(f0) and slope <= (1.0 - 2.0 * c1) * -slope0
        return f, g, slope, (armijo or approx) and math.isfinite(f)

    def zoom(lo, hi, f_lo, evals):
        best = (0.0, f0, g0)
        while evals < max_evals:
            t = 0.5 * (lo + hi)
            f, g, slope, decrease = trial(t)
            evals += 1
            if not decrease or f > f_lo:
                hi = t
                continue
            best = (t, f, g)
            if abs(slope) <= -c2 * slope0:
                return best
            if slope * (hi - lo) >= 0:
                hi = lo
            lo, f_lo = t, f
        return best

    t_prev, f_prev, t, evals = 0.0, f0, 1.0, 0
    best = (0.0, f0, g0)
    while evals < max_evals:
        f, g, slope, decrease = trial(t)
        evals += 1
        if not decrease or (evals > 1 and f > f_prev):
            found = zoom(t_prev, t, f_prev, evals)
            return found if found[0] > 0 else best
        best = (t, f, g)
        if abs(slope) <= -c2 * slope0:
            return best
        if slope >= 0:
            found = zoom(t, t_prev, f, evals)
            return found if found[0] > 0 else best
        t_prev, f_prev, t = t, f, 2.0 * t
    return best


def _lbfgs_fit(loss_fn, params0, max_iters: int, tol: float, memory: int = 10):
    """Minimize `loss_fn(params)` with L-BFGS from `params0`; stops after
    `max_iters` iterations or, past the second, once an iteration changes
    the loss by less than tol·max(|loss|, 1), or when the line search finds
    no step. The first direction is the gradient scaled by
    min(1, 1/||g||), later ones the two-loop recursion over the last
    `memory` pairs with the initial scaling s·y / y·y. The recursion stays
    on the tensors' device; an iteration reads to the host only φ'(0) and
    s·y (to branch on) besides the line search's trials. Returns (detached
    params, final loss, iterations)."""
    shapes = [p.shape for p in params0]
    sizes = [p.numel() for p in params0]

    def unflat(v):
        return [c.reshape(sh) for c, sh in zip(torch.split(v, sizes), shapes)]

    def value_grad(v):
        v = v.detach().requires_grad_(True)
        f = loss_fn(unflat(v))
        (g,) = torch.autograd.grad(f, v)
        return f.detach(), g

    def gradient_step(g):  # -g · min(1, 1/||g||), on the device
        return -g * torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)

    x = torch.cat([p.detach().reshape(-1) for p in params0])
    f, g = value_grad(x)
    f = float(f)
    pairs = []  # (s, y, rho): rho = 1 / s·y, a host float read once per pair
    it = 0
    while it < max_iters:
        if pairs:
            q = g.clone()
            alphas = []
            for s_, y_, rho in reversed(pairs):
                a = rho * (s_ @ q)
                alphas.append(a)
                q -= a * y_
            s_, y_, rho = pairs[-1]
            q *= 1.0 / (rho * (y_ @ y_))
            for (s_, y_, rho), a in zip(pairs, reversed(alphas)):
                q += (a - rho * (y_ @ q)) * s_
            d = -q
        else:
            d = gradient_step(g)
        slope0 = float(g @ d)
        if not slope0 < 0:  # not a descent direction: restart from the gradient
            pairs.clear()
            d = gradient_step(g)
            slope0 = float(g @ d)
        t, f_new, g_new = _wolfe_step(value_grad, x, f, g, slope0, d)
        if t == 0.0:
            break
        s_, y_ = t * d, g_new - g
        sy = float(s_ @ y_)
        if sy > 0:
            pairs = (pairs + [(s_, y_, 1.0 / sy)])[-memory:]
        prev = f
        x, f, g = x + s_, f_new, g_new
        it += 1
        if it > 1 and abs(f - prev) < tol * max(abs(prev), 1.0):
            break
    params = unflat(x.detach())
    return params, loss_fn(params), it


@on_input_device("x", "w", sequences=("factors",))
def cp_objective(factors, x, denom, w=None):
    """``||W .* (X - [[U]])||² / denom``, the objective of ``cp_opt`` (no
    `w`) and ``cp_wopt``; `x` is already weighted when `w` is given."""
    model = ktensor_full(list(factors))
    resid = x - (model if w is None else w * model)
    return (resid**2).sum() / denom


@on_input_device("x", sequences=("init_factors",))
def cp_opt(x, rank, max_iters=200, tol=1e-8, generator=None, init_factors=None):
    """CP by direct optimization — ``cp_opt.m`` semantics: minimize
    ``||X - [[U_1..U_N]]||²`` over all factors jointly with L-BFGS
    (the toolbox delegates to Poblano's limited-memory BFGS; ``cp_fg.m``'s
    function/gradient pair comes from autograd here)."""
    if init_factors is None:
        init_factors = _normal_init(generator, x, rank)
    x = x.detach()
    norm_x_sq = float((x**2).sum())

    def loss(factors):
        return cp_objective(factors, x, norm_x_sq)

    params, final_loss, iters = _lbfgs_fit(loss, init_factors, max_iters, tol)
    factors, weights = cp_normalize(params)
    fit = 1.0 - torch.sqrt(torch.clamp(final_loss, min=0.0))
    return {"weights": weights, "factors": factors, "fit": fit, "n_iters": iters}


@on_input_device("x", "w", sequences=("init_factors",))
def cp_wopt(x, w, rank, max_iters=200, tol=1e-8, generator=None, init_factors=None):
    """Weighted CP optimization — ``cp_wopt.m`` semantics: minimize
    ``||W .* (X - [[U]])||²`` (W a {0,1} or general weight tensor; the
    toolbox's dense 'normal' method). The standard tensor-completion CP
    fit; zero-weight entries never influence the factors."""
    if init_factors is None:
        init_factors = _normal_init(generator, x, rank)
    w = w.detach()
    wx = w * x.detach()
    denom = float((wx**2).sum()) or 1.0

    def loss(factors):
        return cp_objective(factors, wx, denom, w)

    params, final_loss, iters = _lbfgs_fit(loss, init_factors, max_iters, tol)
    factors, weights = cp_normalize(params)
    fit = 1.0 - torch.sqrt(torch.clamp(final_loss, min=0.0))
    return {"weights": weights, "factors": factors, "fit": fit, "n_iters": iters}


# ------------------------------------------------------------------ gcp_opt


def _huber(x, m, delta=0.25):
    d = torch.abs(x - m)
    return torch.where(d < delta, (x - m) ** 2, 0.5 * d - 0.0625)


#: Generalized CP losses — ``gcp_opt.m`` 'type' table (f(x, m), link
#: constraint): each entry maps to (elementwise loss, lower bound on the
#: model entries). Names follow the toolbox.
GCP_LOSSES = {
    # Gaussian: (m - x)^2
    "normal": (lambda x, m: (m - x) ** 2, None),
    # Poisson with identity link: m - x log m
    "count": (lambda x, m: m - x * torch.log(torch.clamp(m, min=1e-10)), 0.0),
    # Poisson with log link: exp(m) - x m
    "poisson-log": (lambda x, m: torch.exp(m) - x * m, None),
    # Bernoulli odds: log(m + 1) - x log m
    "binary": (
        lambda x, m: torch.log(m + 1.0) - x * torch.log(torch.clamp(m, min=1e-10)),
        0.0,
    ),
    # Bernoulli logit: log(1 + exp(m)) - x m
    "bernoulli-logit": (
        lambda x, m: torch.logaddexp(torch.zeros_like(m), m) - x * m,
        None,
    ),
    # Rayleigh: 2 log m + (pi/4)(x/m)^2
    "rayleigh": (
        lambda x, m: 2.0 * torch.log(torch.clamp(m, min=1e-10))
        + (math.pi / 4.0) * (x / torch.clamp(m, min=1e-10)) ** 2,
        0.0,
    ),
    # Huber (delta=0.25, the toolbox default parameterization)
    "huber": (_huber, None),
}


@on_input_device("x", "mask", sequences=("init_factors",))
def gcp_opt(
    x,
    rank,
    loss: str = "normal",
    mask=None,
    max_iters: int = 500,
    learning_rate: float = 0.01,
    tol: float = 1e-9,
    generator=None,
    init_factors=None,
):
    """Generalized CP with a user-specified elementwise loss — ``gcp_opt.m``
    semantics (loss table above = its 'type' option; `mask` = its missing-
    data weight tensor). Fits with Adam, as the reference does (the
    toolbox's dense default is L-BFGS-B and its stochastic default Adam);
    lower-bounded losses are enforced by projection onto
    ``p >= lower + 1e-6`` after each step, like the toolbox's bound
    constraint. `objective` is the value at the last point a step was taken
    from."""
    if loss not in GCP_LOSSES:
        raise ValueError(f"unknown loss {loss!r}; options: {sorted(GCP_LOSSES)}")
    loss_fn, lower = GCP_LOSSES[loss]
    if init_factors is None:
        if lower is None:
            init_factors = _normal_init(generator, x, rank)
        else:
            init_factors = [0.5 * u + 0.01 for u in _uniform_init(generator, x, rank)]
    x = x.detach()
    w = torch.ones_like(x) if mask is None else mask.detach().to(x.dtype)
    n_obs = torch.clamp(w.sum(), min=1.0)
    params = [u.detach().clone().requires_grad_(True) for u in init_factors]

    def objective():
        m = ktensor_full(params)
        return (w * loss_fn(x, m)).sum() / n_obs

    def project(ps):
        for p in ps:
            p.clamp_(min=lower + 1e-6)

    final_obj, iters = adam_descent(
        objective, params, learning_rate, max_iters, tol,
        project=None if lower is None else project,
    )
    factors, weights = cp_normalize([p.detach() for p in params])
    return {
        "weights": weights,
        "factors": factors,
        "objective": final_obj,
        "n_iters": iters,
    }
