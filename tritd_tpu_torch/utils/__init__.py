"""Presets and artifacts. Counterpart of `tritd_tpu/utils/`."""
