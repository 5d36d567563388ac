"""Validation and measurement tools of the port, run with `python -m tritd_tpu_torch.tools.<name>`."""
