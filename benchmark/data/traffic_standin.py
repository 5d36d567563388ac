"""Seeded stand-in of a traffic tensor (taxi, sensor, network, chicago).

A frozen copy of the port's recipe (`tritd_tpu_torch/data/loaders.py`,
`synthetic_traffic`), drawn on the device in a few large calls: a unit-RMS low-TriTD-rank part (standard-normal cores, the triple
product written as the plain einsum iqs,qjs,qst->ijt), plus `cp_weight` times
a unit-RMS seasonal low-CP part (standard-normal spatial factors, harmonic
sinusoids of the period with random phases plus a slow linear trend), plus
white noise at `noise` of the norm, all times `scale`, drawn from
`data_gen`. Then `masks` observation masks from `mask_gen`, each with exactly
round(missing_ratio * numel) entries missing, drawn uniformly without
replacement, and the zero-filled observed tensor of each
(`traffic_triple_comparison.m:27-32`).
"""

from __future__ import annotations

import math

import torch


def unit_rms(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.sqrt(torch.mean(x * x)) + 1e-12)


def low_tritd(gen: torch.Generator, shape, rank: int, device) -> torch.Tensor:
    n1, n2, n3 = shape
    a = torch.randn((n1, rank, rank), generator=gen, device=device, dtype=torch.float64)
    b = torch.randn((rank, n2, rank), generator=gen, device=device, dtype=torch.float64)
    c = torch.randn((rank, rank, n3), generator=gen, device=device, dtype=torch.float64)
    return unit_rms(torch.einsum("iqs,qjs,qst->ijt", a, b, c))


def seasonal_cp(gen: torch.Generator, shape, rank: int, period: float, device) -> torch.Tensor:
    n1, n2, n3 = shape
    a = torch.randn((n1, rank), generator=gen, device=device, dtype=torch.float64)
    b = torch.randn((n2, rank), generator=gen, device=device, dtype=torch.float64)
    phase = 2.0 * math.pi * torch.rand((rank,), generator=gen, device=device, dtype=torch.float64)
    trend = torch.randn((rank,), generator=gen, device=device, dtype=torch.float64)
    t = torch.arange(n3, device=device, dtype=torch.float64)[:, None]
    harm = torch.arange(1, rank + 1, device=device, dtype=torch.float64)[None, :]
    c = torch.sin(2.0 * math.pi * harm * t / period + phase) + 0.3 * trend * (t / n3)
    return unit_rms(torch.einsum("ir,jr,tr->ijt", a, b, c))


def make(config: dict, data_gen: torch.Generator, mask_gen: torch.Generator, device) -> dict:
    """{"truth": X, "observed": [Y_0, ...]} in the configuration's dtype."""
    shape, p = tuple(config["shape"]), config["standin"]
    dtype = getattr(torch, config["dtype"])
    x = low_tritd(data_gen, shape, p["tritd_rank"], device)
    x = x + p["cp_weight"] * seasonal_cp(data_gen, shape, p["cp_rank"], p["period"], device)
    noise = torch.randn(shape, generator=data_gen, device=device, dtype=torch.float64)
    x = p["scale"] * (x + p["noise"] * torch.linalg.vector_norm(x) / torch.linalg.vector_norm(noise) * noise)
    x = x.to(dtype).contiguous()  # the solvers' kernels take contiguous tensors, as the CLIs' numpy input is
    total = x.numel()
    missing = round(config["missing_ratio"] * total)
    observed = []
    for _ in range(config["masks"]):
        keep = torch.ones(total, dtype=torch.bool, device=device)
        keep[torch.randperm(total, generator=mask_gen, device=device)[:missing]] = False
        observed.append(torch.where(keep.view(shape), x, torch.zeros((), dtype=dtype, device=device)).contiguous())
    return {"truth": x, "observed": observed}
