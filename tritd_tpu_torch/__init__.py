"""tritd_tpu_torch — robust Triple Tensor Decomposition (TriTD-ADMM) in
PyTorch, with a hand-written CUDA kernel for NVIDIA Hopper.

A port of the JAX package `tritd_tpu`, which stays the reference: each module
names its JAX counterpart, keeps its layouts and semantics, and is held to
it by the `tests/test_torch_*.py` parity tests. Everything runs on the device
of the input tensor. On a CUDA device the fused elementwise ADMM block runs
the kernel in `csrc/elementwise_block.cu`, built with nvcc on first use; on
the CPU it runs its plain PyTorch version. Importing the package builds
nothing.

Layers:
  ops/       folds, designs (and the explicit-Kronecker kron_*), normal
             equations (with the bf16 einsum_dtype), shrinkage, the Hopper
             kernel and its narrow-storage variants
  runtime/   nvcc build and ctypes binding of csrc/
  solvers/   TriTD-ADMM (f32/f64, bf16 storage), checkpointed, nonconvex
             outlier, ALS/MALS
  parallel/  mode-1 slab, mode-3 frame and DP x TP sharded TriTD-ADMM over a
             torch.distributed process group, the multi-process bootstrap
             and worker
  data/      synthetic stand-ins + .mat ingest (v7.3 too) + ground truth
  metrics/   RRE, PSNR/SSIM/MSAM, CDnet foreground scores
  cli/       completion and video drivers, figures
  utils/     presets, artifacts, checkpoints, the published tables,
             timers, debug switches, the roofline models
  interop    factors and state carried over from the JAX package
"""

__version__ = "0.1.0"

from .ops.designs import triple_product
from .ops.shrinkage import soft_threshold
from .solvers import TriTDConfig, TriTDResult, TriTDState, tritd_admm

__all__ = [
    "TriTDConfig",
    "TriTDResult",
    "TriTDState",
    "tritd_admm",
    "triple_product",
    "soft_threshold",
]
