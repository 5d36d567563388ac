"""SOFIA's two hand-written Hopper kernels (`csrc/sofia_kernels.cu`) and
their plain PyTorch versions.

Neither kernel replaces a Pallas kernel: the reference computes both with
`jnp` inside its device loops (`tritd_tpu/baselines/sofia.py:69`, the
vmapped pinv of the mode-1/2 row solves, and `:175`, the `lax.scan` of the
mode-3 Gauss-Seidel sweep). They are what lets the port's loops of
`baselines/sofia.py` run as CUDA graphs: torch's pinv checks LAPACK's
`info` on the host, which a capture refuses, and the sweep in torch is
about four launches a row.

Each wrapper takes its plain version for tensors on the CPU, and for CUDA
tensors launches its kernel on the current stream or raises: nothing falls
back. A launch adds one to its count in `hopper_kernels.SOFIA_LAUNCHES`
(so a CUDA graph's replays count it too, `hopper_kernels.CountedGraph`).
The library is built and loaded at the first CUDA call, never at import.
"""

from __future__ import annotations

import functools

import torch

from . import hopper_kernels

# The largest rank the kernels take: one warp a matrix, a lane a column.
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
    """The mode-3 Gauss-Seidel sweep: out[t] = (rhs0[t] + lam1 out[t-1] +
    lam2 out[t-m]) @ inv[t], t in order, for rhs0 (n3, r) and inv (n3, r,
    r). On a CUDA device one launch of `tritd_gauss_seidel_sweep_*`; r at
    most MAX_RANK there."""
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
