"""The `tt_trpca` traffic: the completion protocol's TTNN row
(`cli/run_completion.py::run_method`), back to back.

Solve i takes the observed tensor i mod (the configuration's masks) and runs
`tritd_tpu_torch.baselines.ttnn.tt_trpca` for the traffic's iterations on its
SVT route (`svt_method`), with the truth as `origin`. TT-TRPCA starts from
zeros, so a solve draws nothing.
"""

from __future__ import annotations

import torch

from tritd_tpu_torch.baselines.ttnn import tt_trpca

from ..reference import tt_trpca as reference
from .compare import relative_gap

PRESET = "tt_trpca"


class Method:
    def __init__(self, config: dict, traffic: dict, data: dict, device):
        self.preset = config["presets"][PRESET]
        self.iterations = traffic["iterations"]
        self.svt_method = traffic["svt_method"]
        self.observed = data["observed"]
        self.instance = data.get("instance", list(range(len(self.observed))))
        self.origin = data["truth"] if config["origin"] else None

    def inputs(self, i: int, gen: torch.Generator) -> dict:
        k = i % len(self.observed)
        return {"y": self.observed[k], "instance": self.instance[k]}

    def solve(self, inp: dict) -> dict:
        p = self.preset
        z, s, err_hist, _n = tt_trpca(inp["y"], lam=p["lam"], f=p["f"], gamma=p["gamma"], deta=p["deta"],
                                      origin=self.origin, max_iter=self.iterations, svt_method=self.svt_method)
        return {"z": z, "s": s, "err_hist": err_hist}

    @staticmethod
    def finite(out: dict) -> torch.Tensor:
        """A 0-d bool on the device: Z and S are finite."""
        return torch.isfinite(out["z"].sum() + out["s"].sum())

    def reference(self, inp: dict, dtype: torch.dtype = torch.float64, tf32: bool = False) -> dict:
        return reference.solve(inp["y"], self.preset, self.iterations, origin=self.origin, dtype=dtype, tf32=tf32)

    @staticmethod
    def compare(out: dict, ref: dict) -> dict:
        """Relative Frobenius gaps of Z and S. The RRE history is not
        compared: its entries are float32 norms over the whole tensor, whose
        rounding (about 2e-6 of an RRE near 0.3) is as large as what a TF32
        solve moves them by, and `SVT.m`'s dropping of every shrunk singular
        value at 1 or below steps an early entry by about 1 / ||X|| on
        either precision, so no limit would part the program from the
        control; Z does (this sandbox's CPU at 50x50x250: Z 4.5e-7 against
        1.4e-4, the last RRE 1.7e-6 against 2.2e-6)."""
        return {"z": relative_gap(out["z"], ref["z"]), "s": relative_gap(out["s"], ref["s"])}
