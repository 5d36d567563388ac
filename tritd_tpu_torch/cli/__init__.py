"""Experiment drivers. Counterpart of `tritd_tpu/cli/`."""
