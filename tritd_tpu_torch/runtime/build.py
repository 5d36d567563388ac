"""Build the package's CUDA sources into one shared library with nvcc.

The library is built on first CUDA use, never at import, from
`tritd_tpu_torch/csrc/*.cu` (with the headers `*.cuh` they include) into
`tritd_tpu_torch/_build/`, and is named by a hash of the sources, headers and
flags, so an edited file builds anew. Each `.cu` is compiled to an object
by its own nvcc process, all started together, and the objects are linked
into one library: the elementwise block's 50 instantiations are spread over
six files, so the build takes about as long as its largest file. Unlike
`tritd_tpu/runtime/build.py`, which returns None and lets callers fall
back, a failed build raises with nvcc's output: a CUDA tensor has no other
route.

The host proximal library (`csrc/proximal.cpp`, g++) is built the same way by
:func:`build_host_library`, which returns None without a toolchain: its
callers in :mod:`tritd_tpu_torch.runtime.native` then use `ops/prox.py`.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources(), *headers()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtritd_kernels_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    nvcc = shutil.which("nvcc") or (str(candidate) if candidate.exists() else None)
    if nvcc is None:
        raise RuntimeError(
            f"nvcc not found on PATH or under {cuda_home}/bin; the CUDA "
            "kernels of tritd_tpu_torch are built from source on first use"
        )
    return nvcc


def compile_library(srcs, out: Path, extra_flags=(), work_dir: Path | None = None) -> list[str]:
    """Compile each source in `srcs` to an object with its own nvcc process,
    all at once, then link the objects into the shared library `out`.
    Returns each compile's stderr (where `-Xptxas -v` writes), in the order
    of `srcs`. Raises RuntimeError with nvcc's output if a step fails."""
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=work_dir) as tmp:
        objs = [Path(tmp) / f"{i}_{Path(src).stem}.o" for i, src in enumerate(srcs)]
        cmds = [[nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", str(obj), str(src)] for src, obj in zip(srcs, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for cmd in cmds]
        outputs = [proc.communicate() for proc in procs]
        for cmd, proc, (stdout, stderr) in zip(cmds, procs, outputs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{stdout}{stderr}")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(out), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return [stderr for _stdout, stderr in outputs]


def build() -> Path:
    """Return the built library, compiling it first if needed. Raises
    RuntimeError with nvcc's output if the compile fails."""
    out = library_path()
    if out.exists():
        return out
    find_nvcc()  # raises before anything is made when there is none
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build by another
    # process never sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        compile_library(sources(), Path(tmp), work_dir=BUILD_DIR)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


HOST_SOURCES = ("proximal.cpp",)
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build_host_library() -> Path | None:
    """Compile (if needed) the host proximal library with g++ and return its
    path, or None where no g++ is to be had. `-march=native` is tried first
    and dropped if the compiler refuses it."""
    srcs = [SRC_DIR / name for name in HOST_SOURCES]
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    for src in srcs:
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libtritd_host_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        for extra in (("-march=native",), ()):
            cmd = [gxx, *HOST_FLAGS, *extra, *map(str, srcs), "-o", tmp]
            if subprocess.run(cmd, capture_output=True).returncode == 0:
                os.replace(tmp, out)
                return out
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
