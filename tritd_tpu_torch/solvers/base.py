"""Shared solver configuration and result containers.

PyTorch counterpart of `tritd_tpu/solvers/base.py`. `TriTDConfig` keeps the
reference's field names, defaults and order, so a config written for one
package reads the same in the other.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch



# The dtypes a run may store its data-sized tensors in or contract in
# (`tritd_tpu/solvers/base.py:45-75` takes any name `jnp.dtype` knows): the
# narrow ones and the two wide ones. Others raise: no caller uses them, and
# Hopper has no conversion for int8 or the float8 `fnuz` formats.
NARROW_DTYPES = ("bfloat16", "float16", "float8_e4m3fn", "float8_e5m2")
WIDE_DTYPES = ("float32", "float64")


def _field_dtype(field: str, name: str | None) -> torch.dtype | None:
    if name is None:
        return None
    if name not in NARROW_DTYPES + WIDE_DTYPES:
        raise NotImplementedError(
            f"cfg.{field}={name!r}: the port takes None or one of {NARROW_DTYPES + WIDE_DTYPES}"
        )
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class TriTDConfig:
    """Hyperparameters of the TriTD solvers.

    Defaults reproduce the completion driver's TriTD preset
    (`traffic_triple_comparison.m:42-51`); the video preset
    (`video_triple_comparison.m:41-49`) is in
    :data:`tritd_tpu_torch.utils.config.VIDEO_TRITD`.
    """

    rank: int = 5
    max_iter: int = 100
    tol: float = 1e-5
    mu: float = 1e-3                # opts.mu — initial muL and muO
    rho: float = 1.25               # opts.rho — mu growth per iteration
    lambda_l1: float = 1.8          # opts.lambda — weight on ||E||_1
    lambda2: float = 1e-3           # opts.lambda2 — ridge for A and B solves
    alpha_c: float = 1e-9           # fixed ridge for the C solve
                                    # (`triple_decomp_ADMM.m:93`)
    mu_cap_factor: float = 1e6      # muL_max = mu * 1e6 (`:17-18`)
    variant: str = "hadamard"       # "hadamard" | "full" contraction
    solve_method: str = "cholesky"  # "cholesky" | "pinv" | "lstsq"
    dtype: str = "float32"
    masked: bool = False            # True: impute unobserved entries with
                                    # L + O each iteration
    use_pallas: bool = False        # kept for field parity; has no effect.
                                    # The device decides the elementwise
                                    # block's route: CUDA tensors always take
                                    # the hand-written kernel, CPU tensors
                                    # its plain PyTorch version.
    disp: bool = False              # print residuals every 10 iterations
                                    # (host print at block boundaries)
    einsum_dtype: str | None = None   # one of NARROW_DTYPES or WIDE_DTYPES:
                                      # the RHS contractions read operands
                                      # rounded to it and accumulate in
                                      # float32 (float64 too); the carried T
                                      # is stored in it
    storage_dtype: str | None = None  # one of NARROW_DTYPES or WIDE_DTYPES:
                                      # D, O, E, Y_L, Y_O (and T) are stored
                                      # in it; the elementwise block converts
                                      # them, computes in cfg.dtype and
                                      # rounds the stores. cfg.dtype itself
                                      # is None
    unroll: int = 1                 # iterations per block (on the card:
                                    # per CUDA graph replay); the stopping
                                    # rule is read on the host only between
                                    # blocks, so an early-stopped run may do
                                    # up to unroll-1 extra iterations

    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def torch_einsum_dtype(self) -> torch.dtype | None:
        """The einsum dtype, cfg.dtype included: as in the reference, any
        einsum dtype accumulates the contractions in float32."""
        return _field_dtype("einsum_dtype", self.einsum_dtype)

    def torch_storage_dtype(self) -> torch.dtype:
        """Dtype of the data-sized tensors (cfg.dtype unless set)."""
        stored = _field_dtype("storage_dtype", self.storage_dtype)
        return self.torch_dtype() if stored is None else stored

    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)


class TriTDState(NamedTuple):
    """ADMM state. Tensors live on the device of the data; the penalties
    and the iteration counter are host numbers, as `run_admm` returns them
    and checkpoints hold them. Inside the loop `admm_iteration` also takes
    a device form, with mu_l, mu_o and k as 0-d tensors on the data's
    device, which the CUDA graph route carries (`admm._AdmmLoop`: the
    loop of `run_admm` and the segments of `tritd_admm_checkpointed`). The
    host form that a loop hands back between two segments, for a save,
    holds the loop's own buffers, which its next segment overwrites."""

    a: torch.Tensor        # (n1, r, r)
    b: torch.Tensor        # (r, n2, r)
    c: torch.Tensor        # (r, r, n3)
    o: torch.Tensor        # (n1, n2, n3) sparse component
    e: torch.Tensor        # (n1, n2, n3) l1 clone of O
    y_l: torch.Tensor      # dual for D - L - O
    y_o: torch.Tensor      # dual for O - E
    t: torch.Tensor        # factor-solve target D - O + Y_L/muL for the
                           # next iteration, written by the elementwise
                           # block; in t_dtype_of(cfg) when that is set
    mu_l: np.floating      # penalty (annealed), numpy scalar of cfg.dtype
    mu_o: np.floating
    k: int                 # iterations done
    err_hist: torch.Tensor  # (hist_len,) combined residual history, NaN-padded
    rre_hist: torch.Tensor  # (hist_len,) oracle RRE vs origin (NaN if none)
    done: torch.Tensor     # 0-d bool on the device: sticky convergence flag


class TriTDResult(NamedTuple):
    """What a solver returns. err_hist/rre_hist are (max_iter,) tensors;
    entries at index >= n_iters are NaN."""

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    o: torch.Tensor
    e: torch.Tensor
    err_hist: torch.Tensor
    rre_hist: torch.Tensor
    n_iters: int


def trim_history(hist, n_iters) -> np.ndarray:
    """Host-side helper: slice a fixed-size history down to the iterations
    actually run (the reference's `errHist = errHist(1:k)` idiom)."""
    if isinstance(hist, torch.Tensor):
        hist = hist.detach().cpu().numpy()
    return np.asarray(hist)[: int(n_iters)]
