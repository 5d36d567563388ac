"""SOFIA (ICDE'21): streaming robust CP factorization with seasonal patterns.

PyTorch counterpart of `tritd_tpu/baselines/sofia.py`. Reference:
`other_methods/sofia/{sofia_init,sofia_als,sofia}.m` plus the Holt-Winters
helpers `hw_add_add_{fit,forecast,update}.m`, `huber.m`, `biweight.m`,
`thres_soft.m`.

Three phases:
  1. **sofia_als** (`sofia_als.m:51-140`): masked CP-ALS with per-row ridge
     systems. Modes 1-2 are row-parallel: the reference's per-row loops
     with pinv on observed-column Grams (`:55-68`) become one masked-Gram
     GEMM and a batched pinv. Mode 3 is GAUSS-SEIDEL in the time index (the
     reference updates U3 rows in place, so row t sees the NEW t-1/t-m and
     the OLD t+1/t+m) with temporal (lambda1) and seasonal (lambda2)
     Tikhonov coupling (`:100-122`): a sequential sweep over time.
  2. **sofia_init** (`sofia_init.m:60-101`): outer loop of ALS + outlier
     peel O = soft(Y - X, lambda3) with lambda3 annealed 0.85x, floored at
     lambda3/100 (`:68-71`).
  3. **sofia (streaming)** (`sofia.m:89-130`): per time step, forecast the
     time factor by additive Holt-Winters, Huber-clean the residual, scaled
     SGD on all factors, update the HW state. The HW fitting
     (`hw_add_add_fit.m:77-90`) replaces MATLAB's fmincon/BFGS with scipy
     L-BFGS-B on the identical SSE objective and bounds. `sofia_stream` runs
     the stream in numpy on the host and is the oracle of
     `sofia_stream_device`, which runs it in tensors on a device.

The three loops run as the reference's device loops do: the ALS
`while_loop` (`_Als`), the epoch `while_loop` (`_Epochs`) and the stream's
`scan` (`_Stream`), each iteration, epoch step or frame a device program of
`solvers.admm._DeviceLoop`/`_Stepper` with its counter, flags and scalars
on the device. On the card each program is a CUDA graph, captured once a
call and replayed (`_graph_route`), and the host reads the ALS stop flag
once an ALS iteration and the epoch's once an epoch, the stream nothing
before its end; the row pinv and the mode-3 step (its systems and its
Gauss-Seidel sweep) are the two kernels of `ops/sofia_kernels.py`. The CPU
runs the same programs without graphs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import sofia_kernels
from ..ops.kruskal import input_device, solver_input
from ..ops.sofia_kernels import _mode3_systems, _spd_inverse  # noqa: F401  (the names the tests use)
from ..ops.shrinkage import soft_threshold
from ..solvers import admm


def _normalize_into_last(us: list, eps: float = 1e-30):
    """Push column norms of the non-temporal factors into the last factor
    (`sofia_als.m:33-38`)."""
    *front, last = us
    out = []
    for u in front:
        w = torch.sqrt(torch.sum(u**2, dim=0))
        out.append(u / (w + eps))
        last = last * w
    return out + [last]


def _khatri_rao(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(n_a, n_b, R) with entry [a, b, r] = u[a, r] * v[b, r]."""
    return u[:, None, :] * v[None, :, :]


def _masked_row_systems(y, omega, wkr):
    """For each row i of the mode: rhs[i] = sum_obs y * w, gram[i] =
    sum_obs w w^T, where wkr is the (n_a, n_b, R) khatri-rao of the other
    two factors and y/omega are laid out with the solved mode as axis 0.
    Two GEMMs over the flattened (a, b) axis: the pairwise products
    w_r * w_R are formed once, then summed under each row's mask."""
    n, r = y.shape[0], wkr.shape[-1]
    w = wkr.reshape(-1, r)
    rhs = y.reshape(n, -1) @ w
    pairs = (w[:, :, None] * w[:, None, :]).reshape(-1, r * r)
    gram = (omega.reshape(n, -1) @ pairs).reshape(n, r, r)
    return rhs, gram


def _pinv_rows(rhs, gram):
    """row_i <- rhs_i @ pinv(gram_i) (the reference's per-row pinv solve),
    one launch of the `pinv_rows` kernel on the card, torch's SVD pinv on
    the CPU (`ops/sofia_kernels.py`).

    Kept a true pinv: the mode-1/2 masked Grams carry no Tikhonov
    diagonal, so an all-missing (or degenerate) slice is genuinely singular
    and the reference's min-norm behavior must be preserved, with the
    reference's cut-off 10 * r * eps (torch's default is ten times
    smaller). The mode-3 batch uses the SPD closed form below instead (its
    systems are provably PD)."""
    r = gram.shape[-1]
    return sofia_kernels.pinv_rows(rhs, gram, 10.0 * r * torch.finfo(gram.dtype).eps)


def _mode3_gauss_seidel(u3, rhs_base, gram_base, lam1, lam2, m):
    """Sequential time-mode update with temporal/seasonal Tikhonov coupling
    (`sofia_als.m:100-122`). Row t uses updated rows t-1, t-m and old rows
    t+1, t+m.

    The t-1 chain makes the sweep sequential, but everything else is done
    for all rows at once before it:

    * the per-row system (Gram + boundary-dependent lam1/lam2 diagonal)
      does not depend on the swept state: all n3 inverses come from the
      SPD closed form (the systems are PD, diag_coef >= lam1);
    * reads of NOT-yet-updated rows (t+1, t+m) are reads of the INPUT
      state, folded into rhs0 for all rows at once;
    * reads of already-updated rows (t-1, t-m) are rows of the output
      written so far.

    On the card the whole step is one launch of the `mode3_sweep` kernel
    (its systems and the sweep); on the CPU its plain version,
    `_mode3_systems` and a row loop (`ops/sofia_kernels.py`)."""
    return sofia_kernels.mode3_sweep(u3, rhs_base, gram_base, lam1, lam2, m)


def _recon(u1, u2, u3):
    """full(ktensor(U)): X[i, j, t] = sum_r u1[i, r] u2[j, r] u3[t, r]."""
    n1, n2, n3 = u1.shape[0], u2.shape[0], u3.shape[0]
    return (_khatri_rao(u1, u2).reshape(n1 * n2, -1) @ u3.T).reshape(n1, n2, n3)


def _graph_route(device: torch.device, r: int) -> bool:
    """Whether SOFIA's loops replay CUDA graphs: on a CUDA device, at every
    rank its kernels take (`sofia_kernels.MAX_RANK`). Nothing on the card's
    path reads back to the host: the mode-3 step inverts its systems in the
    `mode3_sweep` kernel, not by torch's batched Cholesky, which a capture
    refuses under its default back end (`solvers/admm.py`
    `run_admm_batch`)."""
    return device.type == "cuda" and r <= sofia_kernels.MAX_RANK


def _fit_stop(k, fit, fit_new, tol: float):
    """The ALS stop, `(k >= 1) & (|fit - fit_new| < tol)`, on the device in
    the fits' dtype, as the reference computes it (tol rounded to that
    dtype, as a weakly typed constant is)."""
    return (k >= 1) & (torch.abs(fit - fit_new) < tol)


class _Als:
    """The masked smoothed CP-ALS loop of `sofia_als.m:51-140` in its device
    form, the reference's `lax.while_loop` (`tritd_tpu/baselines/sofia.py
    :_als_loop`): the data in fixed buffers (the zero-filled data laid out
    for each mode, its norm, the mask), the carry (u1, u2, u3, the fit, the
    0-d counter k, the flag done) in tensors that each iteration writes in
    place, one iteration a block of `admm._DeviceLoop`, whose graph (with
    `graphs`) is kept across :meth:`start` calls, as `sofia_init` starts the
    loop anew in each epoch. :meth:`start` is a device program of its own:
    the data from `y` (the mask applied), the factors normalized, the first
    fit. The host reads the flag after each iteration short of the cap, and
    nothing else: the counter is checked by the caller (:meth:`check`)."""

    def __init__(self, omega, u, m, lam1, lam2, max_iters, fitchangetol, graphs: bool):
        self.omega = omega
        self.omega_f = omega.to(u[0].dtype)
        self.om2 = self.omega_f.transpose(0, 1).contiguous()
        self.om3 = torch.movedim(self.omega_f, 2, 0).contiguous()
        shape = tuple(omega.shape)
        dtype, device = u[0].dtype, u[0].device
        self.y = torch.zeros(shape, dtype=dtype, device=device)
        self.y2 = torch.zeros_like(self.om2)
        self.y3 = torch.zeros_like(self.om3)
        self.norm_y = torch.zeros((), dtype=dtype, device=device)
        self.m, self.lam1, self.lam2, self.tol = int(m), float(lam1), float(lam2), float(fitchangetol)
        carry = dict(u1=u[0].clone(), u2=u[1].clone(), u3=u[2].clone(), fit=torch.zeros((), dtype=dtype, device=device),
                     k=torch.zeros((), dtype=torch.int64, device=device),
                     done=torch.zeros((), dtype=torch.bool, device=device))
        self.loop = _AlsLoop(lambda c, _data, _out: self._iteration(c), carry, (), int(max_iters), device, graphs)
        self.stepper = self.loop.stepper  # one side stream and pool for the caller's programs too

    @property
    def carry(self) -> dict:
        return self.loop.carry

    def _fit(self, u1, u2, u3):
        return 1.0 - torch.linalg.vector_norm(self.omega_f * (self.y - _recon(u1, u2, u3))) / self.norm_y

    def _prologue(self, y_of) -> None:
        y = y_of()
        ya = torch.where(self.omega, y, torch.zeros_like(y))
        self.y.copy_(ya)
        self.y2.copy_(ya.transpose(0, 1))
        self.y3.copy_(torch.movedim(ya, 2, 0))
        self.norm_y.copy_(torch.linalg.vector_norm(ya))
        c = self.carry
        us = _normalize_into_last([c["u1"], c["u2"], c["u3"]])
        for f, u in zip(("u1", "u2", "u3"), us):
            c[f].copy_(u)
        c["fit"].copy_(self._fit(*us))

    def _iteration(self, carry: dict) -> dict:
        u2, u3 = carry["u2"], carry["u3"]
        # Mode 1
        rhs, gram = _masked_row_systems(self.y, self.omega_f, _khatri_rao(u2, u3))
        u1 = _pinv_rows(rhs, gram)
        u1, u3 = _normalize_into_last([u1, u3])
        # Mode 2
        rhs, gram = _masked_row_systems(self.y2, self.om2, _khatri_rao(u1, u3))
        u2 = _pinv_rows(rhs, gram)
        u2, u3 = _normalize_into_last([u2, u3])
        # Mode 3 (temporal, Gauss-Seidel)
        rhs_base, gram_base = _masked_row_systems(self.y3, self.om3, _khatri_rao(u1, u2))
        u3 = _mode3_gauss_seidel(u3, rhs_base, gram_base, self.lam1, self.lam2, self.m)
        fit_new = self._fit(u1, u2, u3)
        k = carry["k"]
        return dict(u1=u1, u2=u2, u3=u3, fit=fit_new, k=k + 1, done=_fit_stop(k, carry["fit"], fit_new, self.tol))

    def start(self, y_of) -> None:
        """The loop anew from the factors in the carry, on the data that
        `y_of()` makes inside the start's program (from tensors that outlive
        its graph)."""
        self.stepper.run(lambda: self._prologue(y_of), "als start")
        if self.loop.n_done:
            self.loop.restart()

    def run(self) -> int:
        """Iterates to the cap or the stop; returns the iterations run."""
        self.loop.advance(self.loop.max_iter)
        return self.loop.k

    def check(self, counted: torch.Tensor, want: int) -> None:
        """One read: a device counter of iterations against the host's."""
        got = int(counted)
        if got != want:
            raise AssertionError(f"the ALS counter on the device reads {got} after {want} iterations")


class _AlsLoop(admm._DeviceLoop):
    """`admm._DeviceLoop` whose :meth:`advance` reads nothing at its end:
    `_Als.check` compares the counter once a call."""

    def _result(self):
        return self.carry


def _als_loop(y, omega, u1, u2, u3, m, lam1, lam2, max_iters, fitchangetol, graphs: bool = False):
    """The masked CP-ALS loop from (u1, u2, u3) on `y`, in its device form
    (`_Als`); returns (u1, u2, u3, X_hat)."""
    als = _Als(omega, (u1, u2, u3), m, lam1, lam2, max_iters, fitchangetol, graphs)
    with als.stepper.segment():
        als.start(lambda: y)
        n = als.run()
    als.check(als.carry["k"], n)
    c = als.carry
    return c["u1"], c["u2"], c["u3"], _recon(c["u1"], c["u2"], c["u3"])


def sofia_als(y, omega, r, m, lam1, lam2, u_init, max_iters=300, fitchangetol=1e-3, device=None):
    """One masked smoothed CP-ALS solve. u_init = (u1, u2, u3). Returns
    (u1, u2, u3, X_hat), on the device of `y`: a tensor's unless `device`
    names another; the card for numpy (`RuntimeError` without CUDA;
    `device="cpu"` for the plain path). `omega` and `u_init` follow `y`.
    On the card the loop replays a CUDA graph an iteration (`_Als`)."""
    y = solver_input(y, device=device)
    omega = solver_input(omega, torch.bool, y.device)
    u1, u2, u3 = (torch.as_tensor(u, dtype=y.dtype, device=y.device) for u in u_init)
    return _als_loop(y, omega, u1, u2, u3, int(m), float(lam1), float(lam2), int(max_iters), float(fitchangetol),
                     _graph_route(y.device, u1.shape[1]))


class _Epochs:
    """The epoch loop of `sofia_init.m:60-101` in its device form, the
    reference's `_sofia_init_epochs` `while_loop`: each epoch starts the ALS
    loop (`_Als`) on Y - O, runs it to its stop, then one device program
    makes X, peels O = soft(Y - X, lam3), anneals lam3 (a 0-d tensor in the
    run's dtype: max(0.85 lam3, lam3_init / 100)), writes err_hist at the
    device's epoch counter and the epoch's stop flag (rel < tol after the
    first epoch). With `graphs` the ALS start, an ALS iteration and the
    epoch step are three graphs, captured once a call and replayed; the
    host reads the ALS flag after each ALS iteration and the epoch flag
    after each epoch but the first."""

    def __init__(self, y, omega, u, origin, m, lam1, lam2, lam3, max_epoch, tol, als_max_iters, graphs: bool):
        self.y, self.origin, self.tol = y, origin, float(tol)
        self.als = _Als(omega, u, m, lam1, lam2, als_max_iters, 1e-3, graphs)
        self.stepper = self.als.stepper
        dtype, device = y.dtype, y.device
        scalar = lambda v, dt=dtype: torch.full((), v, dtype=dt, device=device)  # noqa: E731
        self.norm_origin = None if origin is None else torch.linalg.vector_norm(origin)
        self.o, self.x = torch.zeros_like(y), torch.zeros_like(y)
        self.lam3, self.lam3_floor = scalar(lam3), scalar(lam3 / 100.0)
        self.err_hist = torch.full((max_epoch,), float("nan"), dtype=dtype, device=device)
        self.epoch, self.als_total = scalar(0, torch.int64), scalar(0, torch.int64)
        self.done = scalar(False, torch.bool)

    def _step(self) -> None:
        c = self.als.carry
        x_new = _recon(c["u1"], c["u2"], c["u3"])
        self.o.copy_(soft_threshold(self.y - x_new, self.lam3))
        self.lam3.copy_(torch.maximum(self.lam3 * 0.85, self.lam3_floor))
        at = self.epoch.reshape(1)
        if self.origin is not None:
            self.err_hist.index_copy_(0, at, (torch.linalg.vector_norm(self.origin - x_new) / self.norm_origin)[None])
        rel = torch.linalg.vector_norm(self.x - x_new) / torch.clamp(torch.linalg.vector_norm(self.x), min=1e-30)
        self.done.copy_((self.epoch > 0) & (rel < self.tol))
        self.x.copy_(x_new)
        self.als_total.add_(c["k"])
        self.epoch.add_(1)

    def run(self, max_epoch: int) -> int:
        """Runs the epochs; returns how many ran."""
        als_iters = n_epochs = 0
        with self.stepper.segment():
            for epoch in range(max_epoch):
                self.als.start(lambda: self.y - self.o)
                als_iters += self.als.run()
                self.stepper.run(self._step, "epoch step")
                n_epochs = epoch + 1
                if epoch > 0 and bool(self.done):
                    break
        self.als.check(self.als_total, als_iters)
        return n_epochs


def sofia_init(
    y,
    omega,
    r: int = 3,
    m: int = 168,
    lam1: float = 0.1,
    lam2: float = 0.001,
    lam3: float = 10.0,
    origin=None,
    max_epoch: int = 100,
    tol: float = 1e-5,
    als_max_iters: int = 300,
    generator: torch.Generator | None = None,
    u_init=None,
    dtype=torch.float32,
    device=None,
):
    """Batch initialization (`sofia_init.m:60-101`), on the device of `y`
    (placed as in :func:`sofia_als`; `omega`, `origin` and `u_init` follow).

    Returns (U=(u1,u2,u3), X_hat, O, errHist vs origin as numpy). omega
    True=observed. Factor init is uniform [0, 1) (`rand`,
    `sofia_init.m:46`), drawn on the CPU from `generator` (default seed 0),
    unless an explicit `u_init=(u1, u2, u3)` is given (a parity harness
    hands both sides identical inits that way). On the card the epochs and
    the ALS iterations replay CUDA graphs (`_Epochs`)."""
    y = solver_input(y, dtype, device)
    return _init_run(y, omega, r, m, lam1, lam2, lam3, origin, max_epoch, tol, als_max_iters, generator, u_init,
                     _graph_route(y.device, r))


def _init_run(y, omega, r, m, lam1, lam2, lam3, origin, max_epoch, tol, als_max_iters, generator, u_init,
              graphs: bool):
    """`sofia_init` on a tensor `y` in the run's dtype: with `graphs` on the
    CUDA graph route, without them the same device programs eagerly (the
    CPU, and the card's comparison route)."""
    dtype, device = y.dtype, y.device
    omega = solver_input(omega, torch.bool, device)
    if u_init is not None:
        u = tuple(torch.as_tensor(v, device=device).to(dtype) for v in u_init)
    else:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        u = tuple(torch.rand((n, r), generator=generator, dtype=dtype).to(device) for n in y.shape)
    if origin is not None:
        origin = torch.as_tensor(origin, device=device).to(dtype)
    epochs = _Epochs(y, omega, u, origin, int(m), float(lam1), float(lam2), float(lam3), int(max_epoch), tol,
                     int(als_max_iters), graphs)
    n_epochs = epochs.run(int(max_epoch))
    c = epochs.als.carry
    hist = epochs.err_hist[:n_epochs].cpu().numpy() if origin is not None else np.zeros((0,))
    return (c["u1"], c["u2"], c["u3"]), epochs.x, epochs.o, hist


# ---------------------------------------------------------------------------
# Holt-Winters (additive/additive): host-side numpy + scipy L-BFGS-B
# ---------------------------------------------------------------------------


def _hw_init_values(w: np.ndarray, m: int):
    """`hw_add_add_init_values`: l0 from every-m samples, b0 from first two
    cycles, s0 from the first cycle."""
    l0 = float(np.mean(w[0::m]))
    b0 = float(np.mean((w[m : 2 * m] - w[:m]) / m))
    s0 = w[:m] - l0
    return l0, b0, s0


def _hw_recursion(x: np.ndarray, y: np.ndarray, m: int, steps: int):
    """The one-step-ahead HW recursion over `steps` observations: level and
    trend of length steps+1, season of length steps+m."""
    alpha, beta, gamma = x[0], x[1], x[2]
    l = np.zeros(steps + 1)
    b = np.zeros(steps + 1)
    s = np.zeros(steps + m)
    l[0], b[0] = x[3], x[4]
    s[:m] = x[5:]
    ac, bc, gc = 1 - alpha, 1 - beta, 1 - gamma
    for i in range(1, steps + 1):
        l[i] = alpha * y[i - 1] - alpha * s[i - 1] + ac * (l[i - 1] + b[i - 1])
        b[i] = beta * (l[i] - l[i - 1]) + bc * b[i - 1]
        s[i + m - 1] = gamma * y[i - 1] - gamma * (l[i - 1] + b[i - 1]) + gc * s[i - 1]
    return l, b, s


def _hw_sse(x: np.ndarray, y: np.ndarray, m: int, max_fval: float) -> float:
    """`hw_add_add_sse_fun`: SSE of the one-step-ahead HW recursion, with the
    reference's soft constraints (alpha*beta != 0, beta <= alpha,
    gamma <= 1 - alpha)."""
    alpha, beta, gamma = x[0], x[1], x[2]
    if alpha * beta == 0:
        return max_fval
    if beta > alpha or gamma > 1 - alpha:
        return max_fval
    n = len(y)
    l, b, s = _hw_recursion(x, y, m, n - 1)
    resid = (l + b + s[:n]) - y
    return float(resid @ resid)


def _hw_predict(x: np.ndarray, y: np.ndarray, m: int):
    """`hw_add_add_predict`: run the recursion one step past the data."""
    n = len(y)
    l, b, s = _hw_recursion(x, y, m, n)
    y_hat = l[:n] + b[:n] + s[:n]
    return y_hat, l[1:], b[1:], s[m:]


def hw_fit(w: np.ndarray, m: int):
    """`hw_add_add_fit`: per-column HW parameter fit. Returns
    (y_hat, L, B, S, F) with L/B/S the state trajectories and F the (3, R)
    smoothing factors. L-BFGS-B stands in for fmincon/BFGS."""
    from scipy.optimize import minimize

    w = np.asarray(w, np.float64)
    n, r = w.shape
    y_hat = np.zeros_like(w)
    ls = np.zeros_like(w)
    bs = np.zeros_like(w)
    ss = np.zeros_like(w)
    fs = np.zeros((3, r))
    max_fval = 1e30
    for c in range(r):
        y = w[:, c]
        l0, b0, s0 = _hw_init_values(y, m)
        alpha0 = 0.5 / m
        x0 = np.concatenate([[alpha0, 0.1 * alpha0, 0.05 * (1 - alpha0), l0, b0], s0])
        bounds = [(0.0, 1.0)] * 3 + [(None, None)] * 2 + [(None, None)] * m
        res = minimize(
            _hw_sse, x0, args=(y, m, max_fval), method="L-BFGS-B",
            bounds=bounds, options={"maxiter": 200},
        )
        x = res.x if np.isfinite(res.fun) else x0
        fs[:, c] = x[:3]
        y_hat[:, c], ls[:, c], bs[:, c], ss[:, c] = _hw_predict(x, y, m)
    return y_hat, ls, bs, ss, fs


def hw_forecast(ls, bs, ss, m: int, h: int = 1) -> np.ndarray:
    """`hw_add_add_forecast`: h-step-ahead forecast from the state tails."""
    r = ls.shape[1]
    out = np.zeros((h, r))
    for t in range(1, h + 1):
        out[t - 1] = ls[-1] + t * bs[-1] + ss[-m + ((t - 1) % m)]
    return out


def hw_update(y_new: np.ndarray, ls, bs, ss, fs, m: int):
    """`hw_add_add_update`: append HW state rows for new observations."""
    alpha, beta, gamma = fs[0], fs[1], fs[2]
    ac, bc, gc = 1 - alpha, 1 - beta, 1 - gamma
    y_new = np.atleast_2d(y_new)
    for t in range(y_new.shape[0]):
        l_new = alpha * y_new[t] - alpha * ss[-m] + ac * (ls[-1] + bs[-1])
        b_new = beta * (l_new - ls[-1]) + bc * bs[-1]
        s_new = gamma * y_new[t] - gamma * (ls[-1] + bs[-1]) + gc * ss[-m]
        ls = np.vstack([ls, l_new])
        bs = np.vstack([bs, b_new])
        ss = np.vstack([ss, s_new])
    return ls, bs, ss


def tensor2stream(y: np.ndarray):
    """`tensor2stream.m`: iterate mode-3 slices of a tensor as a stream."""
    for t in range(y.shape[-1]):
        yield y[..., t]


def compute_nre(x_hat, x) -> float:
    """`compute_nre.m`: ||x - x_hat||_F / ||x||_F."""
    x_hat = np.asarray(x_hat)
    x = np.asarray(x)
    return float(np.linalg.norm(x - x_hat) / np.linalg.norm(x))


def compute_rmse(x_hat, x) -> float:
    """`compute_rmse.m`: sqrt(mean((x - x_hat)^2))."""
    x_hat = np.asarray(x_hat)
    x = np.asarray(x)
    return float(np.sqrt(np.mean((x - x_hat) ** 2)))


def _huber(x: np.ndarray, k: float = 2.0) -> np.ndarray:
    return np.clip(x, -k, k)


def _biweight(x: np.ndarray, k: float = 4.685) -> np.ndarray:
    inside = np.abs(x) <= k
    return np.where(inside, x * (1.0 - (x / k) ** 2) ** 2, 0.0)


def _stream_scan(
    y_tail, omega_tail, u1, u2, w_ring, l_last, b_last, ss_ring, fs, sigma0,
    m, lam1, lam2, mu, phi, need_outlier, graphs: bool = False,
):
    """The streaming phase in tensors (`sofia.m:89-130`), the reference's
    `lax.scan` over the frames: one step per incoming frame: HW forecast,
    Huber residual clean, biweight sigma update, norm-clipped scaled SGD on
    (u1, u2, w_t), factor renormalization, HW state update. The HW level
    and trend are scalars-per-rank, and the season and time-factor
    histories only ever look back m steps, so the carry holds (m, r) rings
    shifted by one row a step (row 0 is step t-m, the last row step t-1)
    instead of the full trajectories. Returns (u1, u2, W, X_hat, O) with one
    entry per frame stacked along axis 0.

    A frame's step is one device program of `admm._DeviceLoop` (no stop
    flag): it reads frame t and writes its outputs at the device's frame
    counter (`index_select`/`index_copy_`), so every step is the same
    function; with `graphs` one CUDA graph, replayed once a frame, and the
    host reads nothing before the end. The host numpy path (sofia_stream)
    is the oracle; the tests pin these steps against it step for step."""
    n_frames = y_tail.shape[0]
    r = u1.shape[1]
    sqrt_r = float(r) ** 0.5
    alpha, beta, gamma = fs[0], fs[1], fs[2]
    dtype, device = u1.dtype, u1.device
    w_out = torch.zeros((n_frames, r), dtype=dtype, device=device)
    x_out = torch.zeros_like(y_tail)
    o_out = torch.zeros_like(y_tail)

    def step(c: dict, _data, _out) -> dict:
        u1, u2, w_ring, ss_ring, l_last, b_last, sigma = (
            c[f] for f in ("u1", "u2", "w_ring", "ss_ring", "l", "b", "sigma"))
        at = c["k"].reshape(1)
        yt, omt = y_tail.index_select(0, at)[0], omega_tail.index_select(0, at)[0]
        s_old = ss_ring[0]
        # forecast (`hw_add_add_forecast.m`, h=1): l + b + s_{t-m}
        ut = l_last + b_last + s_old
        yt_hat = (u1 * ut) @ u2.T
        rt = yt - yt_hat
        z = rt / sigma
        crt = torch.clamp(z, -2.0, 2.0) * sigma            # huber.m, k=2
        inside = torch.abs(z) <= 4.685                     # biweight.m
        rho = torch.where(inside, z * (1.0 - (z / 4.685) ** 2) ** 2, torch.zeros_like(z))
        sigma_new = torch.sqrt(phi * rho * sigma**2 + (1 - phi) * sigma**2)
        sigma = omt * sigma_new + (1 - omt) * sigma
        crt = omt * crt
        # gradients with temporal (w_{t-1}) + seasonal (w_{t-m}) coupling
        cu2 = crt @ u2
        g1 = cu2 * ut
        g2 = (crt.T @ u1) * ut
        g3 = torch.sum(u1 * cu2, dim=0)
        g3 = g3 + lam1 * (w_ring[-1] - ut) + lam2 * (w_ring[0] - ut)
        new = []
        for u, g in ((u1, g1), (u2, g2), (ut, g3)):
            scale = torch.clamp(mu * sqrt_r / (torch.linalg.vector_norm(g) + 1e-30), max=1.0)
            new.append(u + mu * g * scale)
        ut = new[2]
        for i in range(2):
            wts = torch.sqrt(torch.sum(new[i] ** 2, dim=0))
            new[i] = new[i] / (wts + 1e-30)
            ut = ut * wts
        # HW update (`hw_add_add_update.m`)
        l_new = alpha * ut - alpha * s_old + (1 - alpha) * (l_last + b_last)
        b_new = beta * (l_new - l_last) + (1 - beta) * b_last
        s_new = gamma * ut - gamma * (l_last + b_last) + (1 - gamma) * s_old
        w_out.index_copy_(0, at, ut[None])
        x_out.index_copy_(0, at, ((new[0] * ut) @ new[1].T)[None])
        if need_outlier:
            o_out.index_copy_(0, at, (yt - (yt_hat + crt))[None])
        return dict(u1=new[0], u2=new[1], w_ring=torch.cat([w_ring[1:], ut[None]]),
                    ss_ring=torch.cat([ss_ring[1:], s_new[None]]), l=l_new, b=b_new, sigma=sigma, k=c["k"] + 1)

    carry = dict(u1=u1.clone(), u2=u2.clone(), w_ring=w_ring.clone(), ss_ring=ss_ring.clone(), l=l_last.clone(),
                 b=b_last.clone(), sigma=sigma0.clone(), k=torch.zeros((), dtype=torch.int64, device=device))
    loop = admm._DeviceLoop(step, carry, (), n_frames, device, graphs, stops=False)
    loop.advance(n_frames)
    return carry["u1"], carry["u2"], w_out, x_out, o_out


def _stream_setup(y, omega, r, m, cycles, lam1, lam2, lam3, max_epoch, tol, generator, dtype, device,
                  graphs: bool | None = None):
    """What both streaming paths share: the zero-filled float64 stream on
    the host, the batch init on its first m*cycles frames (on `device`;
    `graphs` None: the route `sofia_init` takes, else `_init_run`'s), and
    the normalized factors with their Holt-Winters fit."""
    y = torch.as_tensor(y).cpu().numpy().astype(np.float64)
    omega_np = torch.as_tensor(omega).cpu().numpy().astype(bool)
    y = np.where(omega_np, y, 0.0)
    ti = m * cycles
    head = torch.as_tensor(y[:, :, :ti], device=device).to(dtype)
    if graphs is None:
        init = sofia_init(head, omega_np[:, :, :ti], r, m, lam1, lam2, lam3, max_epoch=max_epoch, tol=tol,
                          generator=generator, dtype=dtype)
    else:
        init = _init_run(head, omega_np[:, :, :ti], r, m, lam1, lam2, lam3, None, max_epoch, tol, 300, generator,
                         None, graphs)
    (u1, u2, u3), x_init, o_init, _ = init
    u1 = u1.cpu().numpy().astype(np.float64)
    u2 = u2.cpu().numpy().astype(np.float64)
    w_init = u3.cpu().numpy().astype(np.float64)
    for u in (u1, u2):
        wts = np.sqrt(np.sum(u**2, axis=0))
        u /= wts + 1e-30
        w_init = w_init * wts
    hw = hw_fit(w_init, m)[1:]
    return y, omega_np, ti, u1, u2, w_init, x_init.cpu().numpy(), o_init.cpu().numpy(), hw


def sofia_stream_device(
    y,
    omega,
    r: int = 3,
    m: int = 168,
    cycles: int = 3,
    lam1: float = 0.1,
    lam2: float = 0.001,
    lam3: float = 10.0,
    mu: float = 0.1,
    phi: float = 0.05,
    max_epoch: int = 100,
    tol: float = 1e-3,
    need_outlier: bool = True,
    generator: torch.Generator | None = None,
    dtype=torch.float32,
    device=None,
):
    """Streaming SOFIA with the per-step phase in tensors on `device` (by
    default a tensor `y`'s device, the card for numpy: `RuntimeError`
    without CUDA, `device="cpu"` for the plain path). Same protocol as
    :func:`sofia_stream`:
    batch init on the first m*cycles frames, host-side HW fit (scipy
    L-BFGS-B, one-time), then the steps. Returns (U=(u1, u2), W, X_hat, O)
    as numpy, like the numpy path. On the card the batch init and the
    stream replay CUDA graphs (`_Epochs`, `_stream_scan`)."""
    device = input_device(y, device)
    return _stream_device_run(y, omega, r, m, cycles, lam1, lam2, lam3, mu, phi, max_epoch, tol, need_outlier,
                              generator, dtype, device, None)


def _stream_device_run(y, omega, r, m, cycles, lam1, lam2, lam3, mu, phi, max_epoch, tol, need_outlier, generator,
                       dtype, device, graphs: bool | None):
    """`sofia_stream_device` on `device`, its init and stream with `graphs`
    on the CUDA graph route, without them eagerly (the comparison route);
    None: the route `sofia_init` and `_graph_route` pick."""
    y, omega_np, ti, u1, u2, w_init, x_init, o_init, (ls, bs, ss, fs) = _stream_setup(
        y, omega, r, m, cycles, lam1, lam2, lam3, max_epoch, tol, generator, dtype, device, graphs)
    if graphs is None:
        graphs = _graph_route(device, r)
    n1, n2, ntimes = y.shape

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)

    u1_d, u2_d, w_out, x_out, o_out = _stream_scan(
        dev(np.moveaxis(y[:, :, ti:], 2, 0)),
        dev(np.moveaxis(omega_np[:, :, ti:], 2, 0).astype(np.float64)),
        dev(u1), dev(u2), dev(w_init[-m:]), dev(ls[-1]), dev(bs[-1]), dev(ss[-m:]), dev(fs),
        dev(0.1 * np.ones((n1, n2))),
        int(m), float(lam1), float(lam2), float(mu), float(phi), bool(need_outlier), graphs,
    )

    def host(a):
        return a.cpu().numpy().astype(np.float64)

    w = np.zeros((ntimes, r))
    w[:ti] = w_init
    w[ti:] = host(w_out)
    x_hat = np.zeros_like(y)
    x_hat[:, :, :ti] = x_init
    x_hat[:, :, ti:] = np.moveaxis(host(x_out), 0, 2)
    o = np.zeros_like(y) if need_outlier else None
    if need_outlier:
        o[:, :, :ti] = o_init
        o[:, :, ti:] = np.moveaxis(host(o_out), 0, 2)
    return (u1_d.cpu().numpy(), u2_d.cpu().numpy()), w, x_hat, o


def sofia_stream(
    y,
    omega,
    r: int = 3,
    m: int = 168,
    cycles: int = 3,
    lam1: float = 0.1,
    lam2: float = 0.001,
    lam3: float = 10.0,
    mu: float = 0.1,
    phi: float = 0.05,
    max_epoch: int = 100,
    tol: float = 1e-3,
    need_outlier: bool = True,
    generator: torch.Generator | None = None,
    device=None,
):
    """Streaming SOFIA (`sofia.m`) with the stream in numpy on the host:
    batch init on the first m*cycles frames on `device` (by default a
    tensor `y`'s device, the card for numpy, as the reference runs
    `sofia_init` on its accelerator: `RuntimeError` without CUDA,
    `device="cpu"` for the plain path), HW fit, then per-step forecast /
    Huber-clean / scaled-SGD / HW-update on the host.

    Returns (U=(u1,u2), W, X_hat, O)."""
    y, omega_np, ti, u1, u2, w_init, x_init, o_init, (ls, bs, ss, fs) = _stream_setup(
        y, omega, r, m, cycles, lam1, lam2, lam3, max_epoch, tol, generator, torch.float32,
        input_device(y, device))
    n1, n2, ntimes = y.shape

    w = np.zeros((ntimes, r))
    w[:ti] = w_init
    x_hat = np.zeros_like(y)
    x_hat[:, :, :ti] = x_init
    o = np.zeros_like(y) if need_outlier else None
    if need_outlier:
        o[:, :, :ti] = o_init
    sigma = 0.1 * np.ones((n1, n2))

    for t in range(ti, ntimes):
        yt = y[:, :, t]
        omt = omega_np[:, :, t].astype(np.float64)
        ut = hw_forecast(ls, bs, ss, m, 1)[0]  # forecast time-factor row
        yt_hat = u1 @ np.diag(ut) @ u2.T
        rt = yt - yt_hat
        crt = _huber(rt / sigma) * sigma  # cleaned residuals
        # sigma update (`sofia.m:sigma_update`)
        rho = _biweight(rt / sigma)
        new = np.sqrt(phi * rho * sigma**2 + (1 - phi) * sigma**2)
        sigma = omt * new + (1 - omt) * sigma
        crt = omt * crt

        g1 = crt @ u2 @ np.diag(ut)
        g2 = crt.T @ u1 @ np.diag(ut)
        khatri = np.einsum("ir,jr->ijr", u1, u2).reshape(-1, r)
        g3 = crt.reshape(1, -1) @ khatri
        g3 = g3[0] + lam1 * (w[t - 1] - ut) + lam2 * (w[t - m] - ut)

        us = [u1, u2, ut]
        gs = [g1, g2, g3]
        for n in range(3):
            gn = gs[n]
            scale = min(1.0, mu * np.sqrt(r) / (np.linalg.norm(gn) + 1e-30))
            us[n] = us[n] + mu * gn * scale
        u1, u2, ut = us
        for u in (u1, u2):
            wts = np.sqrt(np.sum(u**2, axis=0))
            u /= wts + 1e-30
            ut = ut * wts

        ls, bs, ss = hw_update(ut, ls, bs, ss, fs, m)
        w[t] = ut
        x_hat[:, :, t] = np.einsum("ir,jr,r->ij", u1, u2, ut)
        if need_outlier:
            o[:, :, t] = yt - (yt_hat + crt)

    return (u1, u2), w, x_hat, o
