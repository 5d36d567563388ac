"""Presets, artifacts, checkpoints, the published tables, timers, debug
switches and the roofline models. Counterpart of `tritd_tpu/utils/`."""
