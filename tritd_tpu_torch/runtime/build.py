"""Build the package's CUDA sources into one shared library with nvcc.

The library is built on first CUDA use, never at import, from
`tritd_tpu_torch/csrc/*.cu` into `tritd_tpu_torch/_build/`, and is named by
a hash of the sources and flags, so an edited source builds anew. Unlike
`tritd_tpu/runtime/build.py`, which returns None and lets callers fall back,
a failed build raises with nvcc's output: a CUDA tensor has no other route.
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
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


def build() -> Path:
    """Return the built library, compiling it first if needed. Raises
    RuntimeError with nvcc's output if the compile fails."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build by another
    # process never sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
