"""tritd_tpu_torch — robust Triple Tensor Decomposition (TriTD-ADMM) in
PyTorch, with a hand-written CUDA kernel for NVIDIA Hopper.

A port of the JAX package `tritd_tpu`, which stays the reference: each module
names its JAX counterpart, keeps its layouts and semantics, and is held to
it by the `tests/test_torch_*.py` parity tests. Everything runs on the device
of the input tensor. On a CUDA device the fused elementwise ADMM block runs
the kernel in `csrc/elementwise_block.cuh` (entry points in
`csrc/elementwise_block*.cu`), built with nvcc on first use; on the CPU it
runs its plain PyTorch version. Importing the package builds
nothing.

Layers:
  ops/       folds, designs (and the explicit-Kronecker kron_*), normal
             equations (with the narrow einsum_dtype), shrinkage, the
             reference's rounding into bf16/float16/float8 (narrow), the
             Hopper kernel and its narrow variants; the functional Tensor
             Toolbox surface (kruskal, decomp, tenutils, sparse, symmetric,
             cp_variants)
  runtime/   nvcc build and ctypes binding of csrc/
  solvers/   TriTD-ADMM (f32/f64; bf16, float16 or float8 storage and
             einsum), checkpointed, nonconvex
             outlier, ALS/MALS
  parallel/  mode-1 slab, mode-3 frame and DP x TP sharded TriTD-ADMM over a
             torch.distributed process group, the multi-process bootstrap
             and worker
  data/      synthetic stand-ins + .mat ingest (v7.3 too) + ground truth
  metrics/   RRE, PSNR/SSIM/MSAM, CDnet foreground scores
  cli/       completion and video drivers, figures
  utils/     presets, artifacts, checkpoints, the published tables,
             timers, debug switches, the roofline models
  oracle/    numpy emulators of the reference MATLAB solvers (test-only)
  interop    factors, state and Kruskal/Tucker/sparse tensors carried over
             from the JAX package
"""

__version__ = "0.1.0"

from . import ops, solvers
from .ops import soft_threshold, triple_product
from .solvers import (
    OutlierConfig,
    TriTDConfig,
    TriTDResult,
    TriTDState,
    tritd_admm,
    tritd_admm_outlier,
    tritd_als,
    tritd_mals,
)

__all__ = [
    "ops",
    "solvers",
    "TriTDConfig",
    "TriTDResult",
    "TriTDState",
    "tritd_admm",
    "tritd_als",
    "tritd_mals",
    "tritd_admm_outlier",
    "OutlierConfig",
    "triple_product",
    "soft_threshold",
]
