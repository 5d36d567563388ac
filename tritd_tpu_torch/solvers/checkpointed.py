"""Checkpoint/resume execution of the ADMM solver.

PyTorch counterpart of `tritd_tpu/solvers/checkpointed.py`: the solver runs
in segments of `every` iterations and the whole `TriTDState` is saved after
each, so a long run restarts where it stopped. A resumed run is bitwise
equal to an uninterrupted checkpointed run on the same device: the state
carries the duals, the penalties, the histories and the counter, and every
iteration is the same `admm_iteration` call on the same inputs.
"""

from __future__ import annotations

import os

import torch

from ..ops.narrow import narrow_cast
from ..utils.checkpoint import CheckpointManager, load_state, save_state
from .admm import admm_iteration, init_factors, init_state
from .base import TriTDConfig, TriTDResult, TriTDState

# Environment variable of the failure drill: the process exits abruptly, with
# code 17, right after it saved a checkpoint at or past this iteration.
DIE_AFTER_SAVE_STEP = "TRITD_DIE_AFTER_SAVE_STEP"


def run_segment(d: torch.Tensor, state: TriTDState, k_end: int, cfg: TriTDConfig) -> TriTDState:
    """Advance the solver to iteration min(k_end, max_iter) or convergence.
    The stop flag is read on the host after every iteration, as the
    reference's segment loop tests it every iteration."""
    d = d.to(cfg.torch_dtype())
    norm_d = torch.linalg.vector_norm(d)
    d = narrow_cast(d, cfg.torch_storage_dtype())  # narrow copy when configured
    while state.k < k_end and state.k < cfg.max_iter and not bool(state.done):
        state = admm_iteration(d, state, cfg, norm_d=norm_d)
    return state


def tritd_admm_checkpointed(
    d,
    cfg: TriTDConfig,
    ckpt_dir: str,
    every: int = 25,
    init=None,
    generator: torch.Generator | None = None,
    resume: bool = True,
) -> TriTDResult:
    """Run robust TriTD-ADMM on the device of `d` with a checkpoint every
    `every` iterations. If `resume` and ckpt_dir holds a checkpoint, the run
    continues from the latest one. `init`/`generator` as for `tritd_admm`."""
    dtype = cfg.torch_dtype()
    d = torch.as_tensor(d).to(dtype)
    latest = CheckpointManager(ckpt_dir, every).latest() if resume else None
    if latest:
        sd = cfg.torch_storage_dtype()
        state = load_state(
            latest, dtype, d=d, einsum_dtype=cfg.torch_einsum_dtype(),
            storage_dtype=sd if sd != dtype else None, device=d.device,
        )
    else:
        if init is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            init = init_factors(generator, tuple(d.shape), cfg.rank, dtype)
        state = init_state(d, cfg, init)
    # A checkpoint written under a smaller max_iter carries shorter
    # histories; extend them, NaN-filled, so the loop can index to max_iter.
    if state.err_hist.shape[0] < cfg.max_iter:
        pad = torch.full((cfg.max_iter - state.err_hist.shape[0],), float("nan"),
                         dtype=state.err_hist.dtype, device=d.device)
        state = state._replace(
            err_hist=torch.cat([state.err_hist, pad]),
            rre_hist=torch.cat([state.rre_hist, pad]),
        )

    while state.k < cfg.max_iter and not bool(state.done):
        state = run_segment(d, state, state.k + every, cfg)
        save_state(os.path.join(ckpt_dir, f"step_{state.k:06d}.npz"), state)
        # Failure drill: die abruptly right after a checkpoint lands, so that
        # resume is exercised under a real process death.
        die_at = os.environ.get(DIE_AFTER_SAVE_STEP)
        if die_at is not None and state.k >= int(die_at):
            os._exit(17)

    return TriTDResult(
        a=state.a, b=state.b, c=state.c,
        o=state.o.to(dtype), e=state.e.to(dtype),
        err_hist=state.err_hist, rre_hist=state.rre_hist, n_iters=state.k,
    )
