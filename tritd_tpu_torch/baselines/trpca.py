"""t-SVD and sum-of-nuclear-norms tensor RPCA competitors.

PyTorch counterpart of `tritd_tpu/baselines/trpca.py`. Reference:
`other_methods/Low-rank-...-master/lib/compete_methods/{trpca_tnn.m,
trpca_snn.m}` with `proximal_operator/prox_tnn.m` (FFT along mode 3 +
per-frontal-slice SVT), vendored in the TT-TRPCA repo and exercised by its
`Demo_TRPCA.m`.

The tubal prox is one batched complex SVD in the FFT domain (all frontal
slices at once in place of the MATLAB per-slice loop); conjugate symmetry
of the real FFT means the result of the inverse FFT is real up to roundoff
(the real part is taken, like MATLAB's ifft on the reconstructed symmetric
spectrum).

`trpca_snn`'s loop, the reference's `fori_loop`, runs through
`baselines/device_loop.py`: a host loop on the CPU, one CUDA graph replay an
iteration on the card (its SVDs the Jacobi SVD of `ops/device_linalg.py`),
the penalties a table made before the loop. `trpca_tnn` stays a host loop:
its batched complex SVD has no form a graph captures.
"""

from __future__ import annotations

import math

import torch

from ..ops.kruskal import on_input_device, solver_input
from ..ops.shrinkage import prox_l1
from ..ops.svt import svt_ref_compat
from . import device_loop
from .device_loop import Scalars, write
from .penalty import grown_penalty


@on_input_device("y")
def prox_tnn(y: torch.Tensor, rho) -> torch.Tensor:
    """Proximal operator of the tensor nuclear norm (t-SVD, `prox_tnn.m`):
    FFT along mode 3, soft-threshold singular values of every frontal slice,
    inverse FFT."""
    slices = torch.fft.fft(y, dim=2).permute(2, 0, 1)  # (n3, n1, n2) complex
    u, s, vh = torch.linalg.svd(slices, full_matrices=False)
    s = torch.clamp(s - rho, min=0.0)
    xf = (u * s[:, None, :].to(u.dtype)) @ vh
    return torch.fft.ifft(xf.permute(1, 2, 0), dim=2).real


def trpca_tnn(
    x: torch.Tensor,
    lam: float | None = None,
    origin: torch.Tensor | None = None,
    mu: float = 1e-4,
    rho: float = 1.1,
    max_mu: float = 1e10,
    max_iter: int = 100,
    device=None,
):
    """TNN tensor RPCA: min ||L||_* + lam ||S||_1 s.t. X = L + S
    (`trpca_tnn.m`, defaults lambda = 1/sqrt(max(n1,n2)*n3)). Returns
    (L, S, errHist vs origin). A tensor `x` keeps its device unless `device`
    names another; numpy goes to the card (`RuntimeError` without CUDA);
    `origin` follows `x`. A host loop on every device: `prox_tnn`'s batched
    complex SVD (torch's) reads back to the host, which a CUDA graph
    refuses."""
    x = solver_input(x, device=device)
    origin = solver_input(origin, device=x.device)
    n1, n2, n3 = x.shape
    if lam is None:
        lam = 1.0 / (max(n1, n2) * n3) ** 0.5
    lam = float(lam)
    zeros = torch.zeros_like(x)
    norm_origin = torch.linalg.vector_norm(origin) if origin is not None else None
    l, s, y = zeros, zeros, zeros
    err_hist = torch.full((int(max_iter),), float("nan"), dtype=x.dtype, device=x.device)
    for it in range(int(max_iter)):
        mu_k = grown_penalty(mu, rho, it, x.dtype, cap=max_mu)
        l = prox_tnn(-s + x - y / mu_k, 1.0 / mu_k)
        s = prox_l1(-l + x - y / mu_k, lam / mu_k)
        y = y + mu_k * (l + s - x)
        if origin is not None:
            err_hist[it] = torch.linalg.vector_norm(origin - l) / norm_origin
    return l, s, err_hist


def trpca_snn(
    x: torch.Tensor,
    alpha=None,
    mu: float = 1e-4,
    rho: float = 1.1,
    max_mu: float = 1e10,
    max_iter: int = 100,
    device=None,
):
    """Sum-of-nuclear-norms (HoRPCA) tensor RPCA (`trpca_snn.m`): per-mode
    SVT (with the reference's SVT truncation quirk) + shared l1 sparse part.
    Returns (L of mode 1, the reference's `L = L{1}`, E, errHist). `x` is
    placed as in :func:`trpca_tnn`. The loop runs through
    `baselines/device_loop.py` (the module docstring), on the route
    `device_loop.route` picks for the `svd` SVT on the mode unfoldings."""
    x = solver_input(x, device=device)
    dim = tuple(x.shape)
    k = len(dim)
    if alpha is None:
        alpha = tuple(1.0 for _ in dim)
    alpha = tuple(float(a) for a in alpha)
    max_iter = int(max_iter)
    zeros = torch.zeros_like(x)
    norm_x = torch.linalg.vector_norm(x)

    def unfold_i(t, i):
        return torch.movedim(t, i, 0).reshape(dim[i], -1)

    def fold_i(m, i):
        shp = (dim[i],) + tuple(d for j, d in enumerate(dim) if j != i)
        return torch.movedim(m.reshape(shp), 0, i)

    def penalties(it: int) -> dict:
        # the penalty grows in the run's dtype, as the reference's does; the
        # thresholds are the host's double arithmetic on it
        mu_k = grown_penalty(mu, rho, it, x.dtype, cap=max_mu)
        return {"mu": mu_k, "l1": 1.0 / (mu_k * k), **{f"tau{i}": alpha[i] / mu_k for i in range(k)}}

    scalars = Scalars([penalties(it) for it in range(max_iter)], x.dtype, x.device)
    err_hist = torch.full((max_iter,), float("nan"), dtype=x.dtype, device=x.device)

    def step(it, c: dict, _refresh) -> dict:
        sc = scalars.at(it)
        mu_k, e = sc["mu"], c["e"]
        ys = [c[f"y{i}"] for i in range(k)]
        ls = []
        sumtemp = zeros
        for i in range(k):
            ls.append(fold_i(svt_ref_compat(unfold_i(x - e - ys[i] / mu_k, i), sc[f"tau{i}"]), i))
            sumtemp = sumtemp + ls[i] + ys[i] / mu_k
        e = prox_l1(x - sumtemp / k, sc["l1"])
        sum_err = zeros
        new = {"e": e}
        for i in range(k):
            dy = ls[i] + e - x
            sum_err = sum_err + dy
            new[f"y{i}"] = ys[i] + mu_k * dy
            new[f"l{i}"] = ls[i]
        write(err_hist, it, torch.linalg.vector_norm(sum_err) / norm_x)
        return new

    carry = {"e": zeros, **{f"l{i}": zeros for i in range(k)}, **{f"y{i}": zeros for i in range(k)}}
    shapes = [(d, math.prod(dim) // d) for d in dim]
    carry = device_loop.run(step, carry, [None] * max_iter, [max_iter], device_loop.route(x.device, "svd", shapes))
    return carry["l0"], carry["e"], err_hist
