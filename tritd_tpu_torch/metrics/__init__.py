"""Reconstruction metrics. Counterpart of `tritd_tpu/metrics/`."""
