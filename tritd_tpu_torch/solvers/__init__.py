"""TriTD solver layer. Counterpart of `tritd_tpu/solvers/`."""

from .base import TriTDConfig, TriTDResult, TriTDState, trim_history
from .admm import admm_iteration, init_factors, init_state, tritd_admm, update_factors

__all__ = [
    "TriTDConfig",
    "TriTDResult",
    "TriTDState",
    "trim_history",
    "tritd_admm",
    "admm_iteration",
    "init_state",
    "init_factors",
    "update_factors",
]
