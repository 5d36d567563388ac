"""Tensor ops. Counterpart of `tritd_tpu/ops/` (the main-path modules)."""
