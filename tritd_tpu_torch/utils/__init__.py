"""Presets, artifacts, checkpoints and the published tables. Counterpart of
`tritd_tpu/utils/`."""
