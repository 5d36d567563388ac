"""Symmetric tensor operations and eigen solvers — the Tensor Toolbox v3.1
``@symtensor`` / ``@symktensor`` class surface and the ``eig_sshopm`` /
``eig_sshopmc`` / ``eig_geap`` / ``cp_sym`` / ``tucker_sym`` algorithms.

PyTorch counterpart of `tritd_tpu/ops/symmetric.py`. A symmetric tensor is
a dense tensor with equal mode sizes; a symmetric Kruskal tensor is
``(weights, u)`` with one shared factor matrix.

The reference's `lax.while_loop`s of the three eigen-iterations and of
`cp_sym` are loops of `ops/toolbox_loop.py`: on a CUDA tensor one CUDA
graph replay an iteration, the iterate, the eigenvalue (or the Adam state),
the change, the counter and the stop flag on the card, the flag the one
read to the host; on the CPU a host loop of the same iterations. The stop
is tested before each body with `delta = inf` at entry (`max_iters = 0`
returns the normalized start). `n_iters` is a Python int; `converged` a
0-d bool tensor. Random starts come from `generator` (default: seed 0); a
parity run passes `x0` — or, for `cp_sym`, `init=(w0, u0)`, which the
reference has no argument for. `cp_sym` and `gcp_opt` descend with
`adam_descent`: optax's Adam recurrence written out (betas 0.9/0.999, eps
1e-8 outside the root), the reference's optimizer. `tucker_sym`'s loop
stays a host loop (its `eigh` reads to the host).
"""

from __future__ import annotations

import itertools
import math

import torch

from . import toolbox_loop
from .decomp import _leading_basis, tucker_ttm
from .kruskal import default_generator, draw, ktensor_full, on_input_device


@on_input_device("x")
def symmetrize(x: torch.Tensor) -> torch.Tensor:
    """Symmetric part: average over all axis permutations —
    ``symmetrize(tensor)`` / the ``symtensor`` constructor's projection."""
    n = x.ndim
    out = torch.zeros_like(x)
    perms = list(itertools.permutations(range(n)))
    for p in perms:
        out = out + x.permute(p)
    return out / len(perms)


@on_input_device("x")
def is_symmetric(x: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """``issymmetric(tensor)`` as a 0-d bool tensor on the device of `x`."""
    n = x.ndim
    ok = torch.tensor(True, device=x.device)
    for p in itertools.permutations(range(n)):
        ok = ok & (torch.amax(torch.abs(x - x.permute(p))) <= tol)
    return ok


@on_input_device("weights", "u")
def symktensor_full(weights: torch.Tensor, u: torch.Tensor, order: int) -> torch.Tensor:
    """Dense tensor of a symmetric Kruskal operator Σ_r w_r u_r^{⊗m} —
    ``full(symktensor)``."""
    return ktensor_full([u] * order, weights)


@on_input_device("a", "x")
def ttsv(a: torch.Tensor, x: torch.Tensor, keep: int = 1) -> torch.Tensor:
    """Symmetric tensor times the same vector in all but `keep` modes —
    ``ttsv(A, x, -keep)``: keep=0 gives the scalar Axᵐ, keep=1 the gradient
    direction Axᵐ⁻¹ (vector), keep=2 the Hessian-like matrix Axᵐ⁻²."""
    m = a.ndim
    out = a
    for _ in range(m - keep):
        out = torch.tensordot(out, x, dims=([out.ndim - 1], [0]))
    return out


def _power_loop(step, x, lam, real_like, max_iters: int, tol: float):
    """x, lam <- step(x, lam) until |change| < tol or `max_iters` steps,
    through `toolbox_loop.run`; `step` returns (newx, newlam, delta as a 0-d
    tensor of real_like's dtype). Returns (lam, x, delta, iterations)."""
    def iteration(c):
        newx, newlam, delta = step(c["x"], c["lam"])
        return {"x": newx, "lam": newlam, "delta": delta}, delta

    carry = {"x": toolbox_loop.fixed(x), "lam": toolbox_loop.fixed(lam),
             "delta": toolbox_loop.full(math.inf, real_like)}
    carry, it = toolbox_loop.run(iteration, carry, max_iters, tol)
    return carry["lam"], carry["x"], carry["delta"], it


def _random_start(generator, a):
    return draw("normal", default_generator(generator), (a.shape[0],), a.dtype, a.device)


@on_input_device("a", "x0")
def eig_sshopm(
    a: torch.Tensor,
    shift: float = 0.0,
    concave: bool = False,
    max_iters: int = 1000,
    tol: float = 1e-12,
    generator=None,
    x0=None,
):
    """Shifted Symmetric Higher-Order Power Method for a real eigenpair
    ``Axᵐ⁻¹ = λx`` of a symmetric tensor — ``eig_sshopm.m`` semantics
    (update ``eig_sshopm.m:118-131``: x ← normalize(±(Axᵐ⁻¹ + αx)),
    λ = xᵀAxᵐ⁻¹, |Δλ| stop). `concave=True` searches for the minimal
    eigenvalue (the toolbox's 'Concave' flag flips the sign). A sufficiently
    positive (convex) / negative (concave) `shift` guarantees monotone
    convergence (Kolda & Mayo 2011); shift=0 is plain S-HOPM."""
    if x0 is None:
        x0 = _random_start(generator, a)
    sign = -1.0 if concave else 1.0

    def step(x, lam):
        newx = sign * (ttsv(a, x, 1) + shift * x)
        newx = newx / torch.linalg.vector_norm(newx)
        newlam = torch.dot(newx, ttsv(a, newx, 1))
        return newx, newlam, torch.abs(newlam - lam)

    x0 = x0 / torch.linalg.vector_norm(x0)
    lam0 = torch.dot(x0, ttsv(a, x0, 1))
    lam, x, delta, iters = _power_loop(step, x0, lam0, a, max_iters, tol)
    return {"eigval": lam, "eigvec": x, "converged": delta < tol, "n_iters": iters}


@on_input_device("a", "x0")
def eig_sshopmc(
    a: torch.Tensor,
    shift: float = 0.0,
    max_iters: int = 1000,
    tol: float = 1e-10,
    generator=None,
    x0=None,
):
    """Shifted power method for a REAL/COMPLEX eigenpair ``Axᵐ⁻¹ = λx`` of a
    real symmetric tensor — ``eig_sshopmc.m`` semantics (complex iterate,
    update newx = (Axᵐ⁻¹ + αx)/(λ + α) at `:93-94`, λ = xᴴAxᵐ⁻¹ at `:101`,
    stop on ||λ|−|λ_old|| < tol at `:103`; complex random start `:68`).
    A zero iterate surfaces as a NaN eigenpair. Returns dict with complex
    eigval/eigvec (complex64 for a float32 tensor, else complex128)."""
    cdtype = torch.complex64 if a.dtype == torch.float32 else torch.complex128
    if x0 is None:
        generator = default_generator(generator)
        re = 2.0 * draw("uniform", generator, (a.shape[0],), a.dtype, a.device) - 1.0
        im = draw("normal", generator, (a.shape[0],), a.dtype, a.device)
        x0 = torch.complex(re, im)
    x0 = torch.as_tensor(x0, device=a.device).to(cdtype)
    a = a.to(cdtype)
    real_like = torch.zeros((), dtype=x0.real.dtype, device=a.device)
    eps = torch.finfo(real_like.dtype).eps

    def step(x, lam):
        newx = (ttsv(a, x, 1) + shift * x) / (lam + shift)
        nx = torch.linalg.vector_norm(newx)
        newx = newx / torch.where(nx < eps, torch.full_like(nx, math.nan), nx)
        newlam = torch.vdot(newx, ttsv(a, newx, 1))  # conjugates its first argument
        return newx, newlam, torch.abs(torch.abs(newlam) - torch.abs(lam))

    x0 = x0 / torch.linalg.vector_norm(x0)
    lam0 = torch.vdot(x0, ttsv(a, x0, 1))
    lam, x, delta, iters = _power_loop(step, x0, lam0, real_like, max_iters, tol)
    return {"eigval": lam, "eigvec": x, "converged": delta < tol, "n_iters": iters}


@on_input_device("a", "b", "x0")
def eig_geap(
    a: torch.Tensor,
    b: torch.Tensor,
    shift: float = 1.0,
    concave: bool = False,
    max_iters: int = 1000,
    tol: float = 1e-12,
    generator=None,
    x0=None,
):
    """Generalized Eigenproblem Adaptive Power method for
    ``Axᵐ⁻¹ = λ Bxᵐ⁻¹`` (B symmetric positive definite on the sphere) —
    ``eig_geap.m`` semantics (update at `:154`, Euclidean renormalization
    of the iterate at `:155`, |Δλ| stop). The toolbox adapts `shift` from
    the Hessian spectrum; here, as in the reference, it is a fixed margin
    (pass a larger value if λ oscillates)."""
    if x0 is None:
        x0 = _random_start(generator, a)
    beta = -1.0 if concave else 1.0

    def step(x, lam):
        axm1 = ttsv(a, x, 1)
        bxm1 = ttsv(b, x, 1)
        bxm = ttsv(b, x, 0)
        # `eig_geap.m:154`: newx = β(Axᵐ⁻¹ − λBxᵐ⁻¹ + (α+λ)(Bxᵐ)x), then
        # Euclidean renormalization: λ = Axᵐ/Bxᵐ is scale-invariant.
        newx = beta * (axm1 - lam * bxm1 + (shift + lam) * bxm * x)
        newx = newx / torch.linalg.vector_norm(newx)
        newlam = ttsv(a, newx, 0) / ttsv(b, newx, 0)
        return newx, newlam, torch.abs(newlam - lam)

    x0 = x0 / torch.linalg.vector_norm(x0)
    lam0 = ttsv(a, x0, 0) / ttsv(b, x0, 0)
    lam, x, delta, iters = _power_loop(step, x0, lam0, a, max_iters, tol)
    return {"eigval": lam, "eigvec": x, "converged": delta < tol, "n_iters": iters}


def adam_descent(objective, params, learning_rate, max_iters, tol, project=None):
    """Minimize `objective()` over the leaf tensors `params` with Adam, the
    reference's loop (`tritd_tpu/ops/symmetric.py:253-271`,
    `cp_variants.py:459-481`): each step reads the value and its gradient
    at the current point, takes one Adam step from it (then
    `project(new params)` in place, if given), and stops once
    |value - previous value| < tol or after `max_iters` steps. The step is
    optax's `adam` written out (betas 0.9/0.999, eps 1e-8 outside the root,
    bias corrections from the step count on the device), the same on every
    route of `toolbox_loop.run`; `params` are updated in place, so
    `objective` reads them where it always does. Returns (value before the
    last step as a detached 0-d tensor, steps)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    names = [f"p{i}" for i in range(len(params))]
    carry = {"prev": toolbox_loop.full(math.inf, params[0])}
    for name, p in zip(names, params):
        carry[name] = p.detach()  # the parameter's own storage
        carry["m" + name] = torch.zeros_like(p, memory_format=torch.contiguous_format)
        carry["v" + name] = torch.zeros_like(p, memory_format=torch.contiguous_format)

    def iteration(c):
        with torch.enable_grad():
            value = objective()
            grads = torch.autograd.grad(value, params)
        value = value.detach()
        count = (c["k"] + 1).to(value.dtype)
        fields = {"prev": value}
        with torch.no_grad():
            new = []
            for name, g in zip(names, grads):
                m = (1.0 - b1) * g + b1 * c["m" + name]
                v = (1.0 - b2) * (g * g) + b2 * c["v" + name]
                m_hat = m / (1.0 - torch.pow(b1, count))
                v_hat = v / (1.0 - torch.pow(b2, count))
                new.append(c[name] + (-learning_rate) * (m_hat / (torch.sqrt(v_hat) + eps)))
                fields["m" + name], fields["v" + name] = m, v
            if project is not None:
                project(new)
        fields.update(zip(names, new))
        return fields, torch.abs(value - c["prev"])

    carry, it = toolbox_loop.run(iteration, carry, max_iters, tol)
    return carry["prev"], it


@on_input_device("x", sequences=("init",))
def cp_sym(
    x: torch.Tensor,
    rank: int,
    max_iters: int = 500,
    learning_rate: float = 0.02,
    tol: float = 1e-10,
    generator=None,
    init=None,
):
    """Symmetric CP fit ``X ≈ Σ_r w_r u_r^{⊗m}`` — ``cp_sym.m`` semantics
    (the toolbox optimizes the symmetric objective with Poblano L-BFGS or
    fminunc; here, as in the reference, Adam on (w, U) with autograd — same
    objective ``‖X − full(symktensor)‖²/‖X‖²``). `init=(w0, u0)` replaces
    the random start (u0 ~ N(0, 1/n), w0 ~ N(0, 1))."""
    m = x.ndim
    n = x.shape[0]
    if init is None:
        generator = default_generator(generator)
        u0 = draw("normal", generator, (n, rank), x.dtype, x.device) * (1.0 / math.sqrt(n))
        w0 = draw("normal", generator, (rank,), x.dtype, x.device)
    else:
        w0, u0 = (torch.as_tensor(p, device=x.device).to(x.dtype) for p in init)
    x = x.detach()
    norm_sq = torch.clamp((x**2).sum(), min=1e-30)
    w = w0.detach().clone().requires_grad_(True)
    u = u0.detach().clone().requires_grad_(True)

    def loss():
        return ((x - symktensor_full(w, u, m)) ** 2).sum() / norm_sq

    final_loss, iters = adam_descent(loss, [w, u], learning_rate, max_iters, tol)
    w, u = w.detach(), u.detach()
    # normalize columns, absorbing magnitude^m into the weights
    norms = torch.linalg.vector_norm(u, dim=0)
    safe = torch.where(norms > 0, norms, torch.ones_like(norms))
    u = u / safe
    w = w * safe**m
    fit = 1.0 - torch.sqrt(torch.clamp(final_loss, min=0.0))
    return {"weights": w, "u": u, "fit": fit, "n_iters": iters}


@on_input_device("x")
def tucker_sym(
    x: torch.Tensor,
    rank: int,
    max_iters: int = 100,
    tol: float = 1e-10,
):
    """Symmetric Tucker approximation ``X ≈ core ×₁ U ... ×ₘ U`` with one
    shared orthonormal factor — ``tucker_sym.m`` semantics (higher-order
    power iteration: U ← leading left-singular basis of the mode-1 unfolding
    of X projected by Uᵀ on all other modes; fit from the core norm)."""
    m = x.ndim
    norm_x = torch.linalg.vector_norm(x)

    def core_and_fit(u):
        core = tucker_ttm(x, [u] * m, transpose=True)
        resid_sq = torch.clamp(norm_x**2 - (core**2).sum(), min=0.0)
        return core, 1.0 - torch.sqrt(resid_sq) / norm_x

    u = _leading_basis(x, 0, rank)
    fit_prev = -math.inf
    iters = 0
    for it in range(max_iters):
        y = tucker_ttm(x, [None] + [u] * (m - 1), transpose=True)
        u = _leading_basis(y, 0, rank)
        fit = float(core_and_fit(u)[1])
        iters = it + 1
        if abs(fit - fit_prev) < tol:
            break
        fit_prev = fit
    core, fit = core_and_fit(u)
    return {"core": core, "u": u, "fit": fit, "n_iters": iters}
