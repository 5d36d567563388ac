"""SOFIA's hand-written Hopper kernels (`csrc/sofia_kernels.cu`) and their
plain PyTorch versions.

No kernel replaces a Pallas kernel: the reference computes them with `jnp`
inside its device loops (`tritd_tpu/baselines/sofia.py:69`, the vmapped
pinv of the mode-1/2 row solves, and `:121`, the mode-3 step: its systems
and the `lax.scan` of the Gauss-Seidel sweep at `:175`). They are what lets
the port's loops of `baselines/sofia.py` run as CUDA graphs at every rank up
to MAX_RANK: torch's pinv checks LAPACK's `info` on the host, which a
capture refuses, its batched Cholesky cannot be captured under the default
linalg back end, and the mode-3 step in torch is about thirty launches for
its systems and four a row for its sweep. `mode3_sweep` is that whole step
in one launch; `gauss_seidel_sweep`, the sweep alone on systems made in
torch, stays off the main path as its yardstick.

Each wrapper takes its plain version for tensors on the CPU, and for CUDA
tensors launches its kernel on the current stream or raises: nothing falls
back. A launch adds one to its count in `hopper_kernels.SOFIA_LAUNCHES`
(so a CUDA graph's replays count it too, `hopper_kernels.CountedGraph`).
The library is built and loaded at the first CUDA call, never at import.
"""

from __future__ import annotations

import functools
import math

import torch

from . import hopper_kernels

# The largest rank the kernels take: at most a warp a matrix, a lane a column.
MAX_RANK = 32
_TAGS = {torch.float32: "f32", torch.float64: "f64"}


def pinv_rows_torch(rhs: torch.Tensor, gram: torch.Tensor, rtol: float) -> torch.Tensor:
    """Plain version: rhs[i] @ pinv(gram[i]), singular values at or below
    rtol * the largest cut (torch's SVD pinv)."""
    pinv = torch.linalg.pinv(gram, rtol=rtol)
    return (rhs[:, None, :] @ pinv)[:, 0, :]


def gauss_seidel_sweep_torch(rhs0: torch.Tensor, inv: torch.Tensor, lam1: float, lam2: float, m: int) -> torch.Tensor:
    """Plain version: out[t] = (rhs0[t] + lam1 out[t-1] + lam2 out[t-m]) @
    inv[t] in the order of t, the terms of rows before 0 left out."""
    out = torch.empty_like(rhs0)
    for t in range(rhs0.shape[0]):
        rhs = rhs0[t]
        if t > 0:
            rhs = torch.add(rhs, out[t - 1], alpha=lam1)
        if t >= m:
            rhs = torch.add(rhs, out[t - m], alpha=lam2)
        out[t] = rhs @ inv[t]
    return out


def _spd_inverse(mats: torch.Tensor) -> torch.Tensor:
    """Batched inverse of symmetric positive-definite r x r matrices.

    The mode-3 systems are gram (PSD) + diag_coef * I with diag_coef >=
    lambda1 > 0, so pinv == inv exactly (no singular-value truncation can
    trigger); the closed adjugate form for r <= 3 is then equivalent to the
    reference's pinv up to rounding, in a few elementwise operations. r > 3
    goes through a Cholesky factorization, `cholesky_ex`, which reads
    nothing back to the host: a matrix it cannot factor comes out NaN, as
    the reference's does."""
    r = mats.shape[-1]
    if r == 1:
        return 1.0 / mats
    a = mats
    if r == 2:
        det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        adj = torch.stack(
            [a[..., 1, 1], -a[..., 0, 1], -a[..., 1, 0], a[..., 0, 0]], -1
        ).reshape(a.shape)
        return adj / det[..., None, None]
    if r == 3:
        det = (
            a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0])
        )
        adj = torch.stack(
            [
                a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1],
                a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2],
                a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1],
                a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2],
                a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0],
                a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2],
                a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0],
                a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1],
                a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0],
            ],
            -1,
        ).reshape(a.shape)
        return adj / det[..., None, None]
    low, info = torch.linalg.cholesky_ex(a)
    low = torch.where((info > 0)[..., None, None], torch.full_like(low, math.nan), low)
    return torch.cholesky_inverse(low)


def _mode3_systems(u3, rhs_base, gram_base, lam1, lam2, m):
    """The sweep's inputs (`mode3_sweep_torch`): each row's right-hand
    side with the old rows t+1, t+m folded in, and the inverse of its
    system, both contiguous."""
    n3, r = u3.shape
    dtype, device = u3.dtype, u3.device
    eye = torch.eye(r, dtype=dtype, device=device)
    t_idx = torch.arange(n3, device=device)

    has_prev = (t_idx > 0).to(dtype)
    has_next = (t_idx < n3 - 1).to(dtype)
    # seasonal: t < m -> only +m; m <= t <= n3-m-1 -> both; else only -m
    use_fwd = (t_idx < n3 - m).to(dtype)
    use_bwd = (t_idx >= m).to(dtype)
    diag_coef = lam1 * (has_prev + has_next) + lam2 * (use_fwd + use_bwd)
    inv_all = _spd_inverse(gram_base + diag_coef[:, None, None] * eye[None])

    # old-row contributions (rows t+1 / t+m of the INPUT state)
    rhs0 = (
        rhs_base
        + lam1 * has_next[:, None] * torch.roll(u3, -1, dims=0)
        + lam2 * use_fwd[:, None] * torch.roll(u3, -m, dims=0)
    )
    return rhs0.contiguous(), inv_all.contiguous()


def mode3_sweep_torch(u3, rhs_base, gram_base, lam1: float, lam2: float, m: int) -> torch.Tensor:
    """Plain version of the mode-3 step: the systems (`_mode3_systems`),
    then the sweep (`gauss_seidel_sweep_torch`)."""
    return gauss_seidel_sweep_torch(*_mode3_systems(u3, rhs_base, gram_base, lam1, lam2, m), lam1, lam2, m)


@functools.cache
def _library():
    """The built library, checked for the rank limit this module assumes."""
    from ..runtime import kernels

    lib = kernels.library()
    if lib.tritd_sofia_max_rank() != MAX_RANK:
        raise RuntimeError(f"the library's SOFIA kernels take ranks up to {lib.tritd_sofia_max_rank()}, this module "
                           f"assumes {MAX_RANK}")
    return lib


def _check(name: str, tensors, shapes) -> str:
    """The dtype tag of a launch on these tensors; raises on what the kernel
    does not take."""
    first = tensors[0]
    if first.dtype not in _TAGS:
        raise TypeError(f"{name} kernel takes float32 or float64, got {first.dtype}")
    for x, shape in zip(tensors, shapes):
        if x.dtype != first.dtype or x.device != first.device:
            raise ValueError(f"{name} kernel needs one dtype on one CUDA device, got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous tensors of shapes {shapes}, got {tuple(x.shape)} "
                             f"(contiguous {x.is_contiguous()})")
    rank = shapes[0][-1]
    if not 1 <= rank <= MAX_RANK:
        raise ValueError(f"{name} kernel takes ranks 1 to {MAX_RANK}, got {rank}")
    return _TAGS[first.dtype]


def _launched(name: str, tag: str, err: int) -> None:
    if err:
        from ..runtime import kernels

        kernels.check(err, f"{name}[{tag}] launch")
    hopper_kernels.SOFIA_LAUNCHES[f"{name}[{tag}]"] += 1


def pinv_rows(rhs: torch.Tensor, gram: torch.Tensor, rtol: float) -> torch.Tensor:
    """rhs[i] @ pinv(gram[i]) for n symmetric r x r grams (n, r, r) and rows
    rhs (n, r), eigenvalues of magnitude at or below rtol * the largest
    left out (an all-zero gram gives an exactly zero row). On a CUDA
    device one launch of `tritd_pinv_rows_*`; r at most MAX_RANK there."""
    if rhs.device.type == "cpu":
        return pinv_rows_torch(rhs, gram, rtol)
    n, r = rhs.shape
    tag = _check("pinv_rows", (rhs, gram), ((n, r), (n, r, r)))
    device = rhs.device
    with torch.cuda.device(device):
        out = torch.empty_like(rhs)
        stream = torch._C._cuda_getCurrentRawStream(device.index)
        err = getattr(_library(), f"tritd_pinv_rows_{tag}")(rhs.data_ptr(), gram.data_ptr(), out.data_ptr(), n, r,
                                                            float(rtol), stream)
    _launched("pinv_rows", tag, err)
    return out


def gauss_seidel_sweep(rhs0: torch.Tensor, inv: torch.Tensor, lam1: float, lam2: float, m: int) -> torch.Tensor:
    """The mode-3 Gauss-Seidel sweep alone: out[t] = (rhs0[t] + lam1
    out[t-1] + lam2 out[t-m]) @ inv[t], t in order, for rhs0 (n3, r) and
    inv (n3, r, r). On a CUDA device one launch of
    `tritd_gauss_seidel_sweep_*`; r at most MAX_RANK there. Off the main
    path (`mode3_sweep` takes its place): its time is mode3_sweep's
    yardstick."""
    if int(m) < 1:
        raise ValueError(f"the seasonal period m must be at least 1, got {m}")
    if rhs0.device.type == "cpu":
        return gauss_seidel_sweep_torch(rhs0, inv, lam1, lam2, m)
    n3, r = rhs0.shape
    tag = _check("gauss_seidel_sweep", (rhs0, inv), ((n3, r), (n3, r, r)))
    device = rhs0.device
    with torch.cuda.device(device):
        out = torch.empty_like(rhs0)
        stream = torch._C._cuda_getCurrentRawStream(device.index)
        err = getattr(_library(), f"tritd_gauss_seidel_sweep_{tag}")(
            rhs0.data_ptr(), inv.data_ptr(), out.data_ptr(), n3, r, float(lam1), float(lam2), int(m), stream)
    _launched("gauss_seidel_sweep", tag, err)
    return out


def _mode3_check(u3, rhs_base, gram_base) -> str:
    """The dtype tag of a mode3_sweep launch on these tensors; raises on
    what the kernel does not take."""
    n3, r = u3.shape
    return _check("mode3_sweep", (u3, rhs_base, gram_base), ((n3, r), (n3, r), (n3, r, r)))


def mode3_sweep(u3: torch.Tensor, rhs_base: torch.Tensor, gram_base: torch.Tensor, lam1: float, lam2: float,
                m: int) -> torch.Tensor:
    """The mode-3 step of SOFIA's ALS iteration from the old rows u3 (n3, r),
    the masked right-hand sides rhs_base (n3, r) and grams gram_base (n3, r,
    r): each row's system gram_base[t] + (lam1 (t > 0) + lam1 (t < n3-1) +
    lam2 (t < n3-m) + lam2 (t >= m)) I inverted, the old rows t+1 and t+m
    folded into its right-hand side, then the Gauss-Seidel sweep over t in
    order (`mode3_sweep_torch`). On a CUDA device one launch of
    `tritd_mode3_sweep_*`; r at most MAX_RANK there."""
    if int(m) < 1:
        raise ValueError(f"the seasonal period m must be at least 1, got {m}")
    if u3.device.type == "cpu":
        return mode3_sweep_torch(u3, rhs_base, gram_base, lam1, lam2, m)
    tag = _mode3_check(u3, rhs_base, gram_base)
    n3, r = u3.shape
    device = u3.device
    with torch.cuda.device(device):
        out = torch.empty_like(u3)
        stream = torch._C._cuda_getCurrentRawStream(device.index)
        err = getattr(_library(), f"tritd_mode3_sweep_{tag}")(
            u3.data_ptr(), rhs_base.data_ptr(), gram_base.data_ptr(), out.data_ptr(), n3, r, float(lam1),
            float(lam2), int(m), stream)
    _launched("mode3_sweep", tag, err)
    return out
