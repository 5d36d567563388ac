"""What the demos share: the device flag and the normalized video frames."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..cli.run_completion import resolve_device
from ..data import load_dataset


def add_device_flags(p: argparse.ArgumentParser, cpu_alias: bool = False) -> None:
    """`--device` (default cuda); with `cpu_alias`, also the `--cpu` switch
    of the demos whose reference has one."""
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    if cpu_alias:
        p.add_argument("--cpu", action="store_true", help="the same as --device cpu")


def device_of(args) -> torch.device:
    device = resolve_device("cpu" if getattr(args, "cpu", False) else args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def video_frames(dataset: str, frames: int, device) -> tuple[torch.Tensor, str]:
    """The first `frames` frames of `dataset`, float32 on `device`,
    divided by their largest magnitude (`Demo_TRPCA.m:14`)."""
    x_np, _spec, provenance = load_dataset(dataset)
    x = torch.as_tensor(np.ascontiguousarray(x_np[..., :frames]), dtype=torch.float32, device=device)
    return x / x.abs().max(), provenance


def uniform(shape, seed: int, device) -> torch.Tensor:
    """Uniform [0, 1) numbers from a seeded CPU generator, moved to `device`."""
    return torch.rand(tuple(shape), generator=torch.Generator().manual_seed(seed)).to(device)
