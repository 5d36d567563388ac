"""TriTD solver layer. Counterpart of `tritd_tpu/solvers/`."""

from .base import TriTDConfig, TriTDResult, TriTDState, trim_history
from .admm import admm_iteration, init_factors, init_state, run_admm, t_dtype_of, tritd_admm, update_factors
from .als import tritd_als, tritd_mals
from .outlier import OutlierConfig, tritd_admm_outlier
from .checkpointed import run_segment, tritd_admm_checkpointed

__all__ = [
    "TriTDConfig",
    "TriTDResult",
    "TriTDState",
    "trim_history",
    "tritd_admm",
    "admm_iteration",
    "init_state",
    "run_admm",
    "init_factors",
    "t_dtype_of",
    "update_factors",
    "tritd_als",
    "tritd_mals",
    "OutlierConfig",
    "tritd_admm_outlier",
    "tritd_admm_checkpointed",
    "run_segment",
]
