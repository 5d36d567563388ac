"""Presets, artifacts, checkpoints, the published tables, timers, debug
switches and the roofline models. Counterpart of `tritd_tpu/utils/`."""

from .artifacts import artifact_path, load_artifact, save_artifact, save_raw
from .checkpoint import CheckpointManager, load_state, save_state
from .config import (
    COMPLETION_DATASETS,
    COMPLETION_MISSING_RATIO,
    COMPLETION_TRITD,
    FCTN_PRESET,
    README_MISSING_RATIO,
    RING_PRESET,
    SOFIA_PRESET,
    TTNN_PRESET,
    VIDEO_DATASETS,
    VIDEO_MISSING_RATIO,
    VIDEO_TRITD,
)
from .debug import check_finite, nan_debug, strict_determinism
from .timing import PhaseTimer, device_timer, profiler_trace, sync, time_fn

__all__ = [
    "COMPLETION_TRITD",
    "VIDEO_TRITD",
    "COMPLETION_MISSING_RATIO",
    "README_MISSING_RATIO",
    "VIDEO_MISSING_RATIO",
    "COMPLETION_DATASETS",
    "VIDEO_DATASETS",
    "TTNN_PRESET",
    "RING_PRESET",
    "FCTN_PRESET",
    "SOFIA_PRESET",
    "artifact_path",
    "save_artifact",
    "load_artifact",
    "save_raw",
    "sync",
    "device_timer",
    "PhaseTimer",
    "time_fn",
    "save_state",
    "load_state",
    "CheckpointManager",
    "nan_debug",
    "strict_determinism",
    "check_finite",
    "profiler_trace",
]
