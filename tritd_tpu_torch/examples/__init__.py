"""The port's demos, counterparts of the JAX package's `examples/demo_*.py`:
run each as `python -m tritd_tpu_torch.examples.demo_<name>`, on the card by
default and on the CPU with `--device cpu`."""
