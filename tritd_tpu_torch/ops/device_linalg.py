"""`eigh` and a thin `svd` for the device loops: on the card, calls that
read nothing back to the host, so that a CUDA graph can capture the eigh.

The reference's `jnp.linalg.eigh` and `jnp.linalg.svd` (`tritd_tpu/ops/
svt.py`, `ops/decomp.py`) are XLA library calls, which XLA lowers to
cuSOLVER on a GPU and which check nothing on the host. `torch.linalg.eigh`
and `torch.linalg.svd` read cuSOLVER's `info` back after every call, which a
capture refuses. Here cuSOLVER is called directly (`csrc/device_linalg.cu`),
`info` left on the card, unread: a failed factorization shows as NaN.

* On the CPU both are the plain versions, `torch.linalg.eigh` and
  `torch.linalg.svd(..., full_matrices=False)`.
* On a CUDA tensor each call runs one driver on torch's current stream (a
  capture's stream under capture), with one cuSOLVER handle and one params
  object a device and the workspace a torch tensor allocated at the call
  (from the graph's pool inside a capture). A library that fails to build
  or load raises: nothing falls back to `torch.linalg` on the card.

Which driver (`python -m tritd_tpu_torch.tools.capture_linalg` on the H100,
PERF.md §6): cuSOLVER's syevd, syevj, syevdx, gesvd, gesvdj and gesvdp all
read back to the host inside the call; only the batched syev, with a batch
of one, is captured and replays bitwise, and only up to n = 512. So
:func:`eigh_driver` takes `xsyevbatched` up to XSYEV_BATCHED_MAX_N and
Xsyevd, the driver `torch.linalg.eigh` takes there (and its bits), above
it, which a graph cannot capture: a loop whose eighs are larger takes the
eager loop on the card (:func:`eigh_captures`, chosen before any capture).
:func:`svd_driver` takes gesvdj, the driver `torch.linalg.svd` takes, so
that the SVD keeps torch's bits; a graph cannot capture it, which
`ops/svt.py::UNCAPTURED_METHODS` records.

Layout: a row-major (p, q) tensor is the column-major (q, p) matrix, so
each call passes the transpose that makes the driver see the matrix torch
would hand it, and reads U and V back as views. `CALLS` counts the cuSOLVER
calls per driver and dtype (`hopper_kernels.LINALG_CALLS`); a graph's
replays count too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import hopper_kernels

EIGH_DRIVERS = ("xsyevbatched", "xsyevd")
SVD_DRIVERS = ("gesvdj",)
CALLS = hopper_kernels.LINALG_CALLS
_TAGS = {torch.float32: "f32", torch.float64: "f64"}
_CODES = {torch.float32: 0, torch.float64: 1}

#: The largest n at which cuSOLVER's batched syev can be captured (it reads
#: back to the host from 513 on).
XSYEV_BATCHED_MAX_N = 512
# torch.linalg.svd's gesvdj: the tolerance eps and 400 sweeps
GESVDJ_SWEEPS = 400

_STATUS = {1: "NOT_INITIALIZED", 2: "ALLOC_FAILED", 3: "INVALID_VALUE", 4: "ARCH_MISMATCH", 5: "MAPPING_ERROR",
           6: "EXECUTION_FAILED", 7: "INTERNAL_ERROR", 8: "MATRIX_TYPE_NOT_SUPPORTED", 9: "NOT_SUPPORTED"}


def torch_eigh_driver(n: int, dtype: torch.dtype) -> str:
    """The cuSOLVER driver torch.linalg.eigh takes for one n x n matrix
    (`aten/src/ATen/native/cuda/linalg/BatchLinearAlgebraLib.cpp`)."""
    return "syevj" if dtype == torch.float32 and 32 <= n <= 512 else "xsyevd"


def eigh_driver(n: int, dtype: torch.dtype) -> str:
    """The driver :func:`eigh` takes for an n x n matrix on the card."""
    return "xsyevbatched" if eigh_captures(n) else "xsyevd"


def eigh_captures(n: int) -> bool:
    """Whether a CUDA graph can capture :func:`eigh` of an n x n matrix on
    the card: its driver reads nothing back to the host."""
    return n <= XSYEV_BATCHED_MAX_N


def svd_driver(p: int, q: int, dtype: torch.dtype) -> str:
    """The driver :func:`svd` takes for a (p, q) matrix on the card."""
    return "gesvdj"


@functools.cache
def _library():
    from ..runtime import kernels

    lib = kernels.library()
    if not hasattr(lib, "tritd_linalg_create"):
        raise RuntimeError("the kernels' library has no eigh/SVD entry points (csrc/device_linalg.cu)")
    return lib


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: cuSOLVER status {err} ({_STATUS.get(err, 'unknown')})")


class _Device:
    """One cuSOLVER handle and params object on a device, with gesvdj's
    parameters per dtype, made at the device's first call."""

    def __init__(self, index: int):
        lib = _library()
        self.handle, self.params = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(index):
            _check(lib.tritd_linalg_create(ctypes.byref(self.handle), ctypes.byref(self.params)),
                   "cusolverDnCreate")
        self.gesvdj = {}
        for dtype in _CODES:
            info = ctypes.c_void_p()
            _check(lib.tritd_gesvdj_info_create(ctypes.byref(info), torch.finfo(dtype).eps, GESVDJ_SWEEPS),
                   "gesvdj params")
            self.gesvdj[dtype] = info
        self.sizes: dict = {}  # (driver, dtype, shape) -> workspace sizes, asked once

    def workspace(self, key, ask):
        """The workspace sizes of `key`, from `ask()` at its first call (no
        cuSOLVER query inside a capture that follows)."""
        if key not in self.sizes:
            self.sizes[key] = ask()
        return self.sizes[key]


_DEVICES: dict = {}


def _device(device: torch.device) -> _Device:
    if device.index not in _DEVICES:
        _DEVICES[device.index] = _Device(device.index)
    return _DEVICES[device.index]


def _matrix(a: torch.Tensor, what: str) -> None:
    if a.dim() != 2 or a.dtype not in _CODES:
        raise ValueError(f"{what} takes one float32 or float64 matrix, got {tuple(a.shape)} {a.dtype}")


def _column_major(a: torch.Tensor) -> torch.Tensor:
    """A new buffer holding `a` column-major (the driver overwrites it)."""
    return a.mT.clone(memory_format=torch.contiguous_format)


def _counted(driver: str, dtype: torch.dtype, err: int) -> None:
    _check(err, f"{driver}[{_TAGS[dtype]}]")
    CALLS[f"{driver}[{_TAGS[dtype]}]"] += 1


def _syev(a: torch.Tensor, driver: str):
    """(w, v, info) of the symmetric n x n `a` by one of EIGH_DRIVERS, the
    two of cuSOLVER's 64-bit API with one signature."""
    if driver not in EIGH_DRIVERS:
        raise ValueError(f"unknown eigh driver {driver!r}; use one of {EIGH_DRIVERS}")
    n, device, dt = a.shape[0], a.device, _CODES[a.dtype]
    lib = _library()
    name = f"tritd_{driver}"
    with torch.cuda.device(device):
        state = _device(device)
        buf = _column_major(a)
        w = torch.empty(n, dtype=a.dtype, device=device)
        info = torch.zeros((), dtype=torch.int32, device=device)
        stream = torch._C._cuda_getCurrentRawStream(device.index)

        def ask():
            dev, host = ctypes.c_size_t(), ctypes.c_size_t()
            _check(getattr(lib, f"{name}_buffer")(state.handle, state.params, dt, n, buf.data_ptr(), w.data_ptr(),
                                                  ctypes.byref(dev), ctypes.byref(host)), f"{driver} bufferSize")
            return dev.value, host.value
        dev, host = state.workspace((driver, a.dtype, n), ask)
        work = torch.empty(max(dev, 1), dtype=torch.uint8, device=device)
        host_work = torch.empty(host, dtype=torch.uint8) if host else None
        err = getattr(lib, name)(state.handle, state.params, dt, n, buf.data_ptr(), w.data_ptr(), work.data_ptr(),
                                 dev, None if host_work is None else host_work.data_ptr(), host, info.data_ptr(),
                                 stream)
    _counted(driver, a.dtype, err)
    return w, buf.mT, info


def eigh_with_info(a: torch.Tensor):
    """(w, v, info) of the symmetric `a` (its lower triangle, as
    `torch.linalg.eigh`'s UPLO="L"): eigenvalues ascending, eigenvectors
    the columns of v, info cuSOLVER's 0-d int32 on the card, unread. A CUDA
    tensor only; the driver of :func:`eigh_driver`."""
    _matrix(a, "eigh")
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError(f"eigh takes a square matrix, got {tuple(a.shape)}")
    return _syev(a, eigh_driver(n, a.dtype))


def svd_with_info(a: torch.Tensor):
    """(u, s, vh, info): the thin SVD of `a` (p, q) by gesvdj, s descending,
    u (p, k), vh (k, q) with k = min(p, q), info cuSOLVER's 0-d int32 on
    the card, unread. A CUDA tensor only."""
    _matrix(a, "svd")
    p, q = a.shape
    k = min(p, q)
    driver = svd_driver(p, q, a.dtype)
    device, dtype, dt = a.device, a.dtype, _CODES[a.dtype]
    lib = _library()
    with torch.cuda.device(device):
        state = _device(device)
        s = torch.empty(k, dtype=dtype, device=device)
        info = torch.zeros((), dtype=torch.int32, device=device)
        stream = torch._C._cuda_getCurrentRawStream(device.index)
        # a column-major (m = p, n = q), as torch hands it over; U (p x k)
        # and V (q x k) column-major come back as u and vh directly
        buf = _column_major(a)
        u_buf = torch.empty((k, p), dtype=dtype, device=device)
        v_buf = torch.empty((k, q), dtype=dtype, device=device)
        params = state.gesvdj[dtype]

        def ask():
            lwork = ctypes.c_int()
            _check(lib.tritd_gesvdj_buffer(state.handle, params, dt, p, q, buf.data_ptr(), s.data_ptr(),
                                           u_buf.data_ptr(), v_buf.data_ptr(), ctypes.byref(lwork)),
                   "gesvdj_bufferSize")
            return lwork.value
        lwork = state.workspace((driver, dtype, (p, q)), ask)
        work = torch.empty(max(lwork, 1), dtype=dtype, device=device)
        err = lib.tritd_gesvdj(state.handle, params, dt, p, q, buf.data_ptr(), s.data_ptr(), u_buf.data_ptr(),
                               v_buf.data_ptr(), work.data_ptr(), lwork, info.data_ptr(), stream)
    _counted(driver, dtype, err)
    return u_buf.mT, s, v_buf, info


def eigh(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(w, v) as `torch.linalg.eigh(a)`: eigenvalues ascending, the
    eigenvectors the columns of v. The plain version on the CPU; on a CUDA
    tensor the driver of :func:`eigh_driver`, nothing read back."""
    if a.device.type == "cpu":
        return torch.linalg.eigh(a)
    w, v, _info = eigh_with_info(a)
    return w, v


def svd(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(u, s, vh) as `torch.linalg.svd(a, full_matrices=False)`. The plain
    version on the CPU; on a CUDA tensor the driver of :func:`svd_driver`,
    nothing read back."""
    if a.device.type == "cpu":
        return torch.linalg.svd(a, full_matrices=False)
    u, s, vh, _info = svd_with_info(a)
    return u, s, vh


def provider() -> str:
    """The file that serves the library's cuSOLVER calls in this process."""
    buf = ctypes.create_string_buffer(4096)
    if _library().tritd_linalg_provider(buf, len(buf)):
        return "unknown (dladdr failed)"
    return buf.value.decode()


def version() -> int:
    """cuSOLVER's version as the serving library reports it."""
    return _library().tritd_linalg_version()
