"""Seeded stand-in of a CDnet2014 video (highway, sofa, office, PETS2006).

A frozen copy of the port's recipe (`tritd_tpu_torch/data/synthetic.py`,
`synthetic_video`), drawn on the device: a low-TriTD-rank
background (standard-normal cores, the plain einsum iqs,qjs,qst->ijt) mapped
affinely into [bg_low, bg_high], plus an (n1/8 x n2/8) block of
`fg_magnitude` whose corner moves 3 rows and 5 columns a frame, wrapping
around. Nothing is missing (`video_triple_comparison.m:4-49`): the observed
tensor is the video itself, and the protocol scores no truth.
"""

from __future__ import annotations

import torch

from .traffic_standin import low_tritd


def make(config: dict, data_gen: torch.Generator, mask_gen: torch.Generator, device) -> dict:
    """{"truth": None, "observed": [video]} in the configuration's dtype
    (nothing is missing, so `mask_gen` draws nothing)."""
    n1, n2, n3 = shape = tuple(config["shape"])
    p = config["standin"]
    x = low_tritd(data_gen, shape, p["rank"], device)
    lo, hi = x.min(), x.max()
    bg = p["bg_low"] + (p["bg_high"] - p["bg_low"]) * (x - lo) / (hi - lo + 1e-9)
    h, w = max(n1 // 8, 1), max(n2 // 8, 1)
    t = torch.arange(n3, device=device)
    r0 = (t * 3) % max(n1 - h, 1)
    c0 = (t * 5) % max(n2 - w, 1)
    rows = torch.arange(n1, device=device)[:, None, None]
    cols = torch.arange(n2, device=device)[None, :, None]
    fg = (rows >= r0) & (rows < r0 + h) & (cols >= c0) & (cols < c0 + w)
    # contiguous, as the CLIs' numpy input is: the einsum leaves another layout, which the kernels refuse
    video = (bg + p["fg_magnitude"] * fg).to(getattr(torch, config["dtype"])).contiguous()
    return {"truth": None, "observed": [video]}
