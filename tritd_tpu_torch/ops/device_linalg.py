"""`eigh` and a thin `svd` for the device loops: on the card, calls that
read nothing back to the host, so that a CUDA graph can capture them.

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
:func:`svd_driver` takes the hand-written one-sided Jacobi SVD
(:func:`jacobi_svd`, `csrc/jacobi_svd.cu`), which a graph captures, where
the thin side is at most SVD_JACOBI_MAX_K, and gesvdj, the driver
`torch.linalg.svd` takes (and its bits), past it, which none does
(:func:`svd_captures`).

Layout: a row-major (p, q) tensor is the column-major (q, p) matrix, so
each call passes the transpose that makes the driver see the matrix torch
would hand it, and reads U and V back as views. `CALLS` counts the cuSOLVER
calls per driver and dtype (`hopper_kernels.LINALG_CALLS`), `JACOBI_LAUNCHES`
the Jacobi SVD's (`hopper_kernels.JACOBI_SVD_LAUNCHES`); a graph's replays
count too.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import hopper_kernels

EIGH_DRIVERS = ("xsyevbatched", "xsyevd")
SVD_DRIVERS = ("jacobi", "gesvdj")
CALLS = hopper_kernels.LINALG_CALLS
JACOBI_LAUNCHES = hopper_kernels.JACOBI_SVD_LAUNCHES
_TAGS = {torch.float32: "f32", torch.float64: "f64"}
_CODES = {torch.float32: 0, torch.float64: 1}

#: The largest n at which cuSOLVER's batched syev can be captured (it reads
#: back to the host from 513 on).
XSYEV_BATCHED_MAX_N = 512
# torch.linalg.svd's gesvdj: the tolerance eps and 400 sweeps
GESVDJ_SWEEPS = 400

#: The largest thin side min(p, q) the Jacobi SVD takes on the card: 64
#: blocks of JACOBI_BLOCK columns. It covers the baselines' taxi cuts (thin
#: sides 100, 500, 1000); the Jacobi's work (64 m k a round, ~k / 8 rounds
#: a sweep) grows as m k^2: past the limit (the video cut's 4800) the SVD
#: keeps gesvdj and its loop the eager loop.
SVD_JACOBI_MAX_K = 1024
#: Columns of the tall form a block holds: a pair of blocks is one 32 x 32
#: problem (csrc/jacobi_svd.cu's kBlock).
JACOBI_BLOCK = 16
#: Columns of the transposed tall form a CTA's slice is cut in; its rows
#: are padded to a multiple (csrc/jacobi_svd.cu's kTile).
JACOBI_TILE = 64
#: The most sweeps a call runs (csrc/jacobi_svd.cu's kSweeps): the sweeps
#: stop on the device at the first that rotates nothing, so a higher cap
#: costs a converging call nothing. Set from the readings of the plain
#: version and the kernel (`tools/jacobi_sweeps`, PERF.md section 6; since
#: the tolerance sqrt(k) eps): a graded spectrum (8 decades) needs up to 40
#: sweeps in float64 at 5000 x 1000, a rank-deficient one 26, a clustered
#: one 23, standard normal matrices and tt_trpca's taxi unfoldings after 90
#: iterations 10-13, the exact families 2-12, standard normal 96000 x k for
#: k = 1-16 at most 8; 48 is 1.2 times the most, past LAPACK's 30. A call
#: still rotating in its last sweep is counted
#: (:func:`jacobi_capped`), and an eager one raises (:func:`jacobi_svd`): a
#: guard, which no matrix of `tools/jacobi_sweeps`' cases reaches since the
#: rounding floor (JACOBI_ROUNDING).
JACOBI_SWEEPS = 48
JACOBI_SWEEPS_BUILT = JACOBI_SWEEPS  # the kernel's own cap, its flags' room; a caller may run fewer
#: LAPACK dgesvj's cap of sweeps: the most a call on an exactly
#: rank-deficient matrix (`tools/jacobi_sweeps`' exact families) may take.
LAPACK_SWEEPS = 30
#: The limits the kernel and its plain version are held to against
#: torch.linalg.svd of the same matrix in float64, in s_max: singular values
#: and the reconstruction (the card tests, `chip_smoke.py`'s phases 9 and
#: 26, the CPU tests). The largest readings at the taxi unfoldings (float32
#: ds 9.4e-7, rec 3.7e-7, vectors 2.5e-6; float64 ds 3.8e-13, rec 5.1e-14,
#: vectors 3.4e-15; PERF.md section 6) times 4 to 10.
JACOBI_LIMITS = {torch.float32: 1e-5, torch.float64: 4e-12}
#: The rotation test's floor: a column whose squared norm (its Gram
#: diagonal) is at most (JACOBI_ROUNDING eps)^2 times the reference, the
#: largest Gram diagonal seen so far (every pair's of the previous round and
#: this pair's), is rounding: the test skips its pairs. The update X <- R X
#: leaves rounding of the large columns in the others, about eps s_max in a
#: static clip's unfolding and up to 16 eps in rank 3 from duplicated
#: columns; those above the floor are rotated as any column. Without the
#: floor such columns of an exactly rank-deficient matrix rotated against
#: each other in every sweep (each rotation's rounding makes new noise, down
#: to underflow, where a zero diagonal beside a nonzero product passed the
#: test), and the call stopped at the cap. Floors of 0.5 to 16 eps took the
#: same sweeps on the exact families (`tools/jacobi_sweeps --cases exact
#: --rounding N`); the floor's cost is accuracy: a singular value up to
#: about 3 times the floor can be spread over columns each under it and
#: lost (graded float32 10000 x 500 reads 1.2e-6 s_max at 4 eps, 4.9e-6 at
#: 16, 2.7e-7 without the floor; PERF.md section 6). So the floor is 4 eps,
#: 4 times the static clip's noise.
JACOBI_ROUNDING = 4
#: A singular value below JACOBI_NEGLIGIBLE eps s_max is negligible: it is
#: returned as 0, and its vector on the side made from the tall form's
#: columns is zero, as an exact zero's. Twice the floor: every column kept
#: passed the test against every other kept one in the last sweep, whatever
#: the rounding of its norm. In float32, 9.5e-7 s_max.
JACOBI_NEGLIGIBLE = 2 * JACOBI_ROUNDING
#: The sweep kernel's launch (:func:`jacobi_plan`): clusters of up to
#: JACOBI_MAX_CLUSTER CTAs (the H100's non-portable size) in teams of up to
#: JACOBI_MAX_TEAM clusters a pair, each CTA a slice of at least
#: JACOBI_MIN_SLICE of the pair's tiles where it has them.
JACOBI_MAX_CLUSTER = 16
JACOBI_MAX_TEAM = 8
#: Pairs a round at the largest thin side, SVD_JACOBI_MAX_K (the kernel's
#: kMaxPairs): the room of its references a pair.
JACOBI_MAX_PAIRS = SVD_JACOBI_MAX_K // (2 * JACOBI_BLOCK)
JACOBI_MIN_SLICE = 4
#: A CTA's shared memory, at most JACOBI_SMEM_LIMIT bytes: the kernel's
#: fixed part (JACOBI_FIXED_SMEM by dtype, csrc/jacobi_svd.cu's kFixed) and
#: its stages of 32 rows of `chunk` tiles, each row padded by JACOBI_PAD
#: elements; a slice that does not stay resident runs through a ring of up
#: to JACOBI_RING stages (kRing), two chunks' copies in flight while one is
#: used, where chunks of JACOBI_MIN_CHUNK tiles fit (float32's 7, not
#: float64's 3 tiles: at 3 tiles a chunk float64 took 8% longer than two
#: stages of 5).
JACOBI_SMEM_LIMIT = 232448
JACOBI_FIXED_SMEM = {torch.float32: 46720, torch.float64: 59008}
JACOBI_PAD = 4
JACOBI_RING = 3
JACOBI_MIN_CHUNK = 5
#: The kernel's state: converged, sweeps run, the grid barrier's count, a
#: pad, then one flag a sweep, then one count a pair (csrc/jacobi_svd.cu's
#: kStateHead).
JACOBI_STATE_HEAD = 4
#: The kernels a call launches, each once: the tall form's and V's set-up,
#: all sweeps, the norms, the sorted write.
JACOBI_KERNELS = ("prep_w_kernel", "prep_v_kernel", "sweep_kernel", "norms_kernel", "write_kernel")

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
    """The driver :func:`svd` takes for a (p, q) matrix on the card: the
    Jacobi SVD up to a thin side of SVD_JACOBI_MAX_K, gesvdj past it."""
    return "jacobi" if svd_captures(p, q) else "gesvdj"


def svd_captures(p: int, q: int) -> bool:
    """Whether a CUDA graph can capture :func:`svd` of a (p, q) matrix on
    the card: the Jacobi SVD reads nothing back; gesvdj does."""
    return min(p, q) <= SVD_JACOBI_MAX_K


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
    the card, unread. A CUDA tensor only; any size (:func:`svd` takes it
    past SVD_JACOBI_MAX_K)."""
    _matrix(a, "svd")
    p, q = a.shape
    k = min(p, q)
    driver = "gesvdj"
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
    _matrix(a, "svd")
    if svd_driver(*a.shape, a.dtype) == "jacobi":
        return jacobi_svd(a.contiguous())
    u, s, vh, _info = svd_with_info(a)
    return u, s, vh


class JacobiPlan(NamedTuple):
    """The geometry of the Jacobi SVD of a (p, q) matrix: its tall form W
    (m x k) held as Wt, nb blocks of JACOBI_BLOCK rows (nb even, at least 2;
    the rows past k zero) of ldw columns (m zero-padded to whole tiles), Vt
    nb JACOBI_BLOCK x ldv; the sweep kernel's launch: `clusters` clusters
    of `cluster` CTAs, every one resident at once, in teams of `team`
    clusters a pair (or one cluster several pairs a round where fewer fit
    than there are pairs), each CTA a slice of ceil(tiles / (team
    cluster)) tiles staged in `stages` stages of `chunk` tiles (one: the
    slice resident; more: a ring of chunks), `smem` bytes of shared
    memory."""

    k: int
    m: int
    wide: bool
    nb: int
    ldw: int
    ldv: int
    cluster: int
    team: int
    clusters: int
    chunk: int
    stages: int
    smem: int


def _staging(per: int, dtype: torch.dtype) -> tuple[int, int, int]:
    """(chunk, stages, smem) of a CTA's slice of `per` tiles: resident in
    one stage where it fits, else the fewest balanced chunks of the
    deepest ring (up to JACOBI_RING stages) whose chunks hold
    JACOBI_MIN_CHUNK tiles, or of two stages."""
    size = torch.finfo(dtype).bits // 8
    fixed = JACOBI_FIXED_SMEM[dtype]

    def stage(chunk: int) -> int:
        return 2 * JACOBI_BLOCK * (chunk * JACOBI_TILE + JACOBI_PAD) * size

    if fixed + stage(per) <= JACOBI_SMEM_LIMIT:
        return per, 1, fixed + stage(per)
    for stages in range(JACOBI_RING, 1, -1):
        most = ((JACOBI_SMEM_LIMIT - fixed) // (stages * 2 * JACOBI_BLOCK * size) - JACOBI_PAD) // JACOBI_TILE
        if most >= JACOBI_MIN_CHUNK or stages == 2:
            chunk = -(-per // -(-per // most))
            return chunk, stages, fixed + stages * stage(chunk)


def jacobi_plan(p: int, q: int, sms: int, dtype: torch.dtype = torch.float32, active=None) -> JacobiPlan:
    """The plan of a (p, q) matrix of `dtype` on a card of `sms` SMs: of
    the launches whose every CTA the card holds at once, one team a pair,
    the one with the most CTAs (at least JACOBI_MIN_SLICE tiles a CTA: a
    small matrix's rounds are the inner pass's and the barriers' latency,
    which more CTAs do not cut), then the fewest clusters a team, then the
    largest cluster; else, where the card holds fewer clusters than pairs,
    as many clusters of one CTA as it holds.
    `active(cluster, smem)` is how many clusters of that size and shared
    memory the card holds at once (on the card
    cudaOccupancyMaxActiveClusters: the H100 holds 7 of 16, 15 of 8, 30 of
    4, its SMs being in GPCs of 16 to 18); by default sms // cluster, one
    CTA an SM."""
    k, m = min(p, q), max(p, q)
    nb = max(2, -(-k // JACOBI_BLOCK))
    nb += nb % 2
    ldw = -(-m // JACOBI_TILE) * JACOBI_TILE
    tiles, pairs = ldw // JACOBI_TILE, nb // 2
    if active is None:
        def active(cluster: int, _smem: int) -> int:
            return sms // cluster
    best, key = None, None
    slices = max(1, tiles // JACOBI_MIN_SLICE)  # the most CTAs a pair
    for cluster in range(min(JACOBI_MAX_CLUSTER, slices), 0, -1):
        for team in range(min(JACOBI_MAX_TEAM, slices // cluster), 0, -1):
            chunk, stages, smem = _staging(-(-tiles // (team * cluster)), dtype)
            if active(cluster, smem) >= pairs * team:
                candidate = (pairs * team * cluster, -team, cluster)
                if key is None or candidate > key:
                    best, key = (cluster, team, pairs * team, chunk, stages, smem), candidate
                break
    if best is None:  # fewer clusters than pairs: clusters of one CTA, several pairs each
        chunk, stages, smem = _staging(tiles, dtype)
        fit = min(active(1, smem), pairs)
        if fit < 1:
            raise ValueError(f"jacobi_plan: no CTA of {smem} bytes of shared memory fits on the card")
        best = (1, 1, fit, chunk, stages, smem)
    return JacobiPlan(k, m, p < q, nb, ldw, k, *best)


def jacobi_tournament(n: int) -> list[list[tuple[int, int]]]:
    """The round-robin tournament of n players (n even): n - 1 rounds of
    n / 2 disjoint pairs, every pair once (csrc/jacobi_svd.cu's
    `tournament_pair`)."""
    return [[(0 if i == 0 else 1 + (i - 1 + r) % (n - 1), 1 + (n - 2 - i + r) % (n - 1)) for i in range(n // 2)]
            for r in range(n - 1)]


def jacobi_inner_rounds(first: bool) -> list[list[tuple[int, int]]]:
    """The rounds of a pair's inner sweep over its 2 JACOBI_BLOCK indices:
    at the first round of an outer sweep every pair of them (the
    tournament's 2b - 1 rounds), at the others the b^2 pairs across the two
    blocks only (b rounds, index i of the first block with b + (i + r) mod b
    of the second), so that a sweep rotates every pair of columns once, the
    cyclic Jacobi ordering by blocks (csrc/jacobi_svd.cu's `inner_pair`)."""
    b = JACOBI_BLOCK
    if first:
        return jacobi_tournament(2 * b)
    return [[(i, b + (i + r) % b) for i in range(b)] for r in range(b)]


def jacobi_tol(k: int, dtype: torch.dtype) -> float:
    """The rotation test's tolerance: a pair of columns p, q of the tall
    form (m x k, m >= k) rotates where |w_p . w_q| > tol ||w_p|| ||w_q||;
    sqrt(k) eps of the dtype, whatever m. The test bounds each off-diagonal
    of the Gram W^T W relative to its diagonals; what it leaves acts on the
    singular values through that Gram, of size k, so the values are off by
    about the tolerance times s_max on near-equal spectra. The Gram of two
    nearly orthogonal columns rounds at a few eps whatever m is (a running
    sum of products of mixed signs), so a tolerance that does not grow with
    m still stops. LAPACK gesvj's sqrt(m) eps let float32 values of zero
    columns among standard normal ones at 96000 x 240 read 1.1e-5 s_max
    against the float64 SVD, where sqrt(k) eps reads 3.4e-7 in the same
    sweeps (PERF.md section 6)."""
    return math.sqrt(k) * torch.finfo(dtype).eps


def jacobi_floor(dtype: torch.dtype) -> float:
    """The rotation test's floor over the reference (JACOBI_ROUNDING): a
    pair rotates only where both Gram diagonals exceed it times the
    reference."""
    return (JACOBI_ROUNDING * torch.finfo(dtype).eps) ** 2


def jacobi_negligible(dtype: torch.dtype) -> float:
    """The fraction of s_max below which a singular value is returned as 0
    (JACOBI_NEGLIGIBLE)."""
    return JACOBI_NEGLIGIBLE * torch.finfo(dtype).eps


def _inner_schedule(rounds, device) -> tuple[list, torch.Tensor]:
    """`rounds` (:func:`jacobi_inner_rounds`) on `device`: each round's first
    and second indices, and the (n, n) mask of the pairs the sweep tests."""
    pairs = torch.tensor(rounds, device=device)  # (rounds, n / 2, 2)
    n = 2 * pairs.shape[1]
    tested = torch.zeros((n, n), dtype=torch.bool, device=device)
    tested[pairs[..., 0], pairs[..., 1]] = True
    return [(rnd[:, 0], rnd[:, 1]) for rnd in pairs], tested | tested.mT


def _inner_sweep(g: torch.Tensor, tol: float, angle: torch.dtype, schedule,
                 low: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One sweep of cyclic Jacobi over each of the symmetric (n, n) float64
    matrices g (pairs, n, n), in place, in the order of `schedule`
    (:func:`_inner_schedule`: n / 2 disjoint rotations a round), each
    rotation where g_pp > low, g_qq > low (`low` (pairs,): the floor times
    the reference, :func:`jacobi_floor`) and |g_pq| > tol sqrt(g_pp)
    sqrt(g_qq), t = e / (d + sign(d) hypot(d, e)) with d = g_qq - g_pp, e = 2
    g_pq, in the dtype `angle` (the input's), c = rsqrt(1 + t^2), s = c t in
    float64; returns the accumulated rotation R (g's old value is R^T g R)
    and whether each matrix rotated. The kernel's inner pass, the same
    formulas in the same order (its square roots, hypot and rsqrt are the
    card's)."""
    rounds, tested = schedule
    pairs, n, _ = g.shape
    r = torch.eye(n, dtype=g.dtype, device=g.device).expand(pairs, n, n).clone()
    above = g.diagonal(dim1=1, dim2=2) > low[:, None]
    diag = g.diagonal(dim1=1, dim2=2).sqrt()
    rotated = torch.zeros(pairs, dtype=torch.bool, device=g.device)
    if not bool(((g.abs() > tol * diag[:, :, None] * diag[:, None, :]) & tested & above[:, :, None]
                 & above[:, None, :]).any()):
        return r, rotated  # no pair of the sweep passes the test: it rotates nothing
    low = low[:, None]
    for ip, iq in rounds:
        al, be, ga = g[:, ip, ip], g[:, iq, iq], g[:, ip, iq]
        rot = (al > low) & (be > low) & (ga.abs() > tol * al.sqrt() * be.sqrt())
        if not bool(rot.any()):  # a round that rotates nothing changes nothing
            continue
        rotated |= rot.any(dim=1)
        d, e = (be - al).to(angle), (2.0 * ga).to(angle)
        t = torch.where(rot, (e / (d + torch.copysign(torch.hypot(d, e), d))).to(torch.float64), 0.0)
        c = torch.rsqrt(1.0 + t * t)
        s = c * t
        gp, gq = g[:, :, ip], g[:, :, iq]
        g[:, :, ip], g[:, :, iq] = c[:, None, :] * gp - s[:, None, :] * gq, s[:, None, :] * gp + c[:, None, :] * gq
        c, s = c[..., None], s[..., None]
        gp, gq, rp, rq = g[:, ip, :], g[:, iq, :], r[:, ip, :], r[:, iq, :]
        g[:, ip, :], g[:, iq, :] = c * gp - s * gq, s * gp + c * gq
        r[:, ip, :], r[:, iq, :] = c * rp - s * rq, s * rp + c * rq
        g[:, ip, ip], g[:, iq, iq] = al - t * ga, be + t * ga
        zero = torch.where(rot, 0.0, ga)
        g[:, ip, iq], g[:, iq, ip] = zero, zero
    return r, rotated


def _jacobi_torch(a: torch.Tensor):
    """(u, s, vh, sweeps) of :func:`jacobi_svd_torch`; sweeps those that
    ran, the last one the sweep without a rotation (or JACOBI_SWEEPS)."""
    p, q = a.shape
    plan = jacobi_plan(p, q, 1, dtype=a.dtype)  # the launch is the kernel's alone
    dtype, device, b = a.dtype, a.device, JACOBI_BLOCK
    k, rows = plan.k, plan.nb * b
    wt = torch.zeros((rows, plan.m), dtype=dtype, device=device)
    wt[:k] = a if plan.wide else a.mT
    vt = torch.zeros((rows, k), dtype=dtype, device=device)
    vt[:k] = torch.eye(k, dtype=dtype, device=device)
    tol = jacobi_tol(k, dtype)
    block = torch.arange(b, device=device)
    rounds = [torch.tensor(rnd, device=device) for rnd in jacobi_tournament(plan.nb)]
    inner = [_inner_schedule(jacobi_inner_rounds(first), device) for first in (True, False)]
    floor = jacobi_floor(dtype)
    ref = torch.zeros((), dtype=torch.float64, device=device)  # the largest Gram diagonal of the rounds before
    sweeps = 0
    for _ in range(JACOBI_SWEEPS):
        sweeps += 1
        any_rotated = False
        for ri, rnd in enumerate(rounds):
            idx = (rnd[:, :, None] * b + block).reshape(len(rnd), 2 * b)
            x, y = wt[idx], vt[idx]
            g = (x @ x.mT).to(torch.float64)
            # a pair's reference: the largest of its diagonal and the last round's (NaN dropped, as fmax does)
            mine = torch.maximum(g.diagonal(dim1=1, dim2=2).nan_to_num(0.0).amax(dim=1), ref)
            ref = mine.amax()
            r, rotated = _inner_sweep(g, tol, dtype, inner[ri > 0], floor * mine)
            if bool(rotated.any()):
                any_rotated = True
                r, keep = r.to(dtype), rotated[:, None, None]
                wt[idx] = torch.where(keep, r @ x, x)
                vt[idx] = torch.where(keep, r @ y, y)
        if not any_rotated:
            break
    sig = torch.linalg.vector_norm(wt[:k].to(torch.float64), dim=1).to(dtype)
    order = torch.sort(sig, descending=True, stable=True).indices
    s = sig[order]
    smax = s.nan_to_num(0.0).amax().double()
    s = torch.where(s.double() < jacobi_negligible(dtype) * smax, torch.zeros((), dtype=dtype, device=device), s)
    wn = torch.where(s[:, None] > 0, wt[order] / s[:, None], torch.zeros((), dtype=dtype, device=device))
    vs = vt[order]
    u, vh = (vs.mT, wn) if plan.wide else (wn.mT, vs)
    return u, s, vh, sweeps


def jacobi_svd_torch(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of :func:`jacobi_svd`, on any device: the same
    blocks, tournament, rotation test and floor, inner rounds and cap in
    torch ops (the Grams as batched products, so other sums than the
    kernel's). It stops at the first sweep without a rotation, as the
    kernel's sweep loop does, and returns at the cap whether it converged
    or not, as the reference's `jnp.linalg.svd` returns. A singular value
    below JACOBI_NEGLIGIBLE eps s_max is returned as 0; the column of the
    side made from the tall form's columns (U for a tall input, V for a
    wide one) that belongs to a zero singular value is zero."""
    _matrix(a, "jacobi_svd_torch")
    if min(a.shape) < 1:
        raise ValueError(f"jacobi_svd_torch takes a matrix with both sides >= 1, got {tuple(a.shape)}")
    u, s, vh, _sweeps = _jacobi_torch(a)
    return u, s, vh


_CAPPED: dict = {}


def jacobi_capped(device: torch.device) -> torch.Tensor:
    """The 0-d int32 count on `device` of the Jacobi SVD's calls that
    stopped at JACOBI_SWEEPS sweeps without converging (an approximate
    answer): each such call, a graph's replays too, adds one on the card.
    It is kept across calls and read by whoever reads anything else
    (`baselines.device_loop.run` at each segment's end); set it to 0 with
    `zero_()`. Made, as 0, at its first use, which a capture may not be."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    if device.index not in _CAPPED:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("jacobi_capped: make the count (an eager call) before a capture")
        _CAPPED[device.index] = torch.zeros((), dtype=torch.int32, device=device)
    return _CAPPED[device.index]


_DEFERRED = 0  # callers inside :func:`caller_reads_the_cap` (a loop that reads jacobi_capped itself)


@contextlib.contextmanager
def caller_reads_the_cap():
    """Inside it an eager :func:`jacobi_svd` reads nothing back: the caller
    reads :func:`jacobi_capped` itself (`baselines.device_loop`, once a
    segment, its eager first iterations included)."""
    global _DEFERRED
    _DEFERRED += 1
    try:
        yield
    finally:
        _DEFERRED -= 1


@functools.cache
def _jacobi_library():
    lib = _library()
    want = {"block": JACOBI_BLOCK, "tile": JACOBI_TILE, "sweeps": JACOBI_SWEEPS_BUILT,
            "f32 fixed smem": JACOBI_FIXED_SMEM[torch.float32], "f64 fixed smem": JACOBI_FIXED_SMEM[torch.float64]}
    got = {"block": lib.tritd_jacobi_block(), "tile": lib.tritd_jacobi_tile(), "sweeps": lib.tritd_jacobi_sweeps(),
           "f32 fixed smem": lib.tritd_jacobi_fixed_smem(0), "f64 fixed smem": lib.tritd_jacobi_fixed_smem(1)}
    if got != want:
        raise RuntimeError(f"the library's Jacobi SVD has {got}, this module assumes {want}")
    return lib


@functools.cache
def _active_clusters(index: int, dtype: torch.dtype, cluster: int, smem: int) -> int:
    """cudaOccupancyMaxActiveClusters of the sweep kernel on device `index`."""
    with torch.cuda.device(index):
        n = _jacobi_library().tritd_jacobi_active_clusters(int(dtype == torch.float64), cluster, smem)
    if n < 0:
        from ..runtime import kernels

        kernels.check(-n, f"jacobi_svd[{_TAGS[dtype]}] occupancy of clusters of {cluster}")
    return n


@functools.cache
def _plan(index: int, p: int, q: int, dtype: torch.dtype) -> JacobiPlan:
    """:func:`jacobi_plan` on device `index`, its occupancy read there; made
    once a shape (it is host work the call would wait on)."""
    return jacobi_plan(p, q, torch.cuda.get_device_properties(index).multi_processor_count, dtype,
                       functools.partial(_active_clusters, index, dtype))


def _jacobi(a: torch.Tensor):
    """(u, s, vh, state) of :func:`jacobi_svd`, state the kernel's int32s on
    the card: converged, sweeps run, ... (JACOBI_STATE_HEAD, then a flag a
    sweep)."""
    _matrix(a, "jacobi_svd")
    if a.device.type != "cuda" or not a.is_contiguous():
        raise ValueError(f"jacobi_svd takes a contiguous CUDA tensor, got one on {a.device} "
                         f"(contiguous {a.is_contiguous()})")
    p, q = a.shape
    if not 1 <= min(p, q) <= SVD_JACOBI_MAX_K:
        raise ValueError(f"jacobi_svd takes a thin side of 1 to {SVD_JACOBI_MAX_K}, got {tuple(a.shape)}")
    if not 1 <= JACOBI_SWEEPS <= JACOBI_SWEEPS_BUILT:
        raise ValueError(f"jacobi_svd runs 1 to {JACOBI_SWEEPS_BUILT} sweeps, not {JACOBI_SWEEPS}")
    dtype, device = a.dtype, a.device
    index = device.index if device.index is not None else torch.cuda.current_device()
    lib = _jacobi_library()
    plan = _plan(index, p, q, dtype)
    capped = jacobi_capped(device)
    k, m, rows, tag = plan.k, plan.m, plan.nb * JACOBI_BLOCK, _TAGS[dtype]
    with torch.cuda.device(device):
        empty = functools.partial(torch.empty, dtype=dtype, device=device)
        wt, vt, sig = empty((rows, plan.ldw)), empty((rows, plan.ldv)), empty(k)
        state = torch.empty(JACOBI_STATE_HEAD + JACOBI_SWEEPS + plan.nb // 2, dtype=torch.int32, device=device)
        gsum = torch.empty((plan.nb // 2, plan.team, 2 * JACOBI_BLOCK, 2 * JACOBI_BLOCK) if plan.team > 1 else 1,
                           dtype=torch.float64, device=device)
        refs = torch.empty((2, JACOBI_MAX_PAIRS), dtype=torch.float64, device=device)
        s, wn, vs = empty(k), empty((k, m)), empty((k, k))
        stream = torch._C._cuda_getCurrentRawStream(index)
        err = getattr(lib, f"tritd_jacobi_svd_{tag}")(
            a.data_ptr(), p, q, wt.data_ptr(), plan.ldw, vt.data_ptr(), plan.ldv, state.data_ptr(), capped.data_ptr(),
            gsum.data_ptr(), refs.data_ptr(), sig.data_ptr(), s.data_ptr(), wn.data_ptr(), vs.data_ptr(), plan.nb,
            plan.cluster, plan.team, plan.clusters, plan.chunk, plan.stages, plan.smem, JACOBI_SWEEPS,
            jacobi_tol(k, dtype), jacobi_floor(dtype), jacobi_negligible(dtype), stream)
    if err:
        from ..runtime import kernels

        kernels.check(err, f"jacobi_svd[{tag}] launch")
    JACOBI_LAUNCHES[f"jacobi_svd[{tag}]"] += 1
    u, vh = (vs.mT, wn) if plan.wide else (wn.mT, vs)
    return u, s, vh, state


def jacobi_svd_with_sweeps(a: torch.Tensor):
    """(u, s, vh, sweeps) of :func:`jacobi_svd`, sweeps a 0-d int32 on the
    card: the sweeps that ran, the last the one without a rotation
    (JACOBI_SWEEPS if it did not converge, which :func:`jacobi_capped`
    counts); it reads nothing back, even outside a capture."""
    u, s, vh, state = _jacobi(a)
    return u, s, vh, state[1]


def jacobi_svd(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(u, s, vh) as `torch.linalg.svd(a, full_matrices=False)`, by the
    hand-written one-sided Jacobi SVD (`csrc/jacobi_svd.cu`): a
    contiguous float32 or float64 CUDA matrix whose thin side is at most
    SVD_JACOBI_MAX_K; it raises on anything else (the plain version,
    :func:`jacobi_svd_torch`, runs anywhere). One call is one launch of
    the kernel family (JACOBI_LAUNCHES), five launches on torch's current
    stream, so a CUDA graph can capture it. Singular values descending; one
    below JACOBI_NEGLIGIBLE eps s_max is negligible (rounding that the
    sweeps leave untested, JACOBI_ROUNDING) and returned as 0, and the
    vectors of a zero one are zero on the side made from the tall form's
    columns (U for a tall input, V for a wide one), where
    `torch.linalg.svd` completes an orthonormal basis.

    At the cap. Outside a capture, and outside :func:`caller_reads_the_cap`,
    the call reads whether it converged (one synchronizing read, as
    `torch.linalg.svd` reads its `info`) and raises RuntimeError if it
    stopped at JACOBI_SWEEPS sweeps still rotating. Under a capture it reads
    nothing: the count :func:`jacobi_capped` records the call for the
    caller's read. The reference's `jnp.linalg.svd` returns in both cases
    (ROADMAP.md's departures)."""
    u, s, vh, state = _jacobi(a)
    if not _DEFERRED and not torch.cuda.is_current_stream_capturing() and not int(state[0]):
        raise RuntimeError(f"jacobi_svd of a {tuple(a.shape)} {a.dtype} matrix stopped at its cap of "
                           f"{JACOBI_SWEEPS} sweeps without converging")
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
