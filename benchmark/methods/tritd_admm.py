"""The `tritd_admm` traffic: what the completion and video protocols call
for TriTD (`cli/run_completion.py::run_method`), back to back.

Solve i takes the observed tensor i mod (the configuration's masks) and the
configuration's one standard-normal factor init, and runs
`tritd_tpu_torch.solvers.tritd_admm` for exactly the traffic's iterations
(tol 0), with the truth as `origin` where the protocol scores it.

The init is drawn on the device from the configuration's `data_seed`, as the
protocol starts every solve from `rng(0)`'s draw, so that with the
configuration's masks every seed solves the same instances. Fresh inits
drew, on the card at taxi, about one solve in 40 whose float32 answer, the
plain reference's in float32 as much as the program's, lies 1e-4 to 2e-3
from float64's, past where the TF32 control starts; with fixed instances
such an instance is known, and `cells/<workload>.json` gives it a limit of
its own, set from its own readings.
"""

from __future__ import annotations

import hashlib

import torch

from tritd_tpu_torch.solvers import TriTDConfig, tritd_admm

from ..reference import tritd_admm as reference
from .compare import relative_gap

PRESET = "tritd_admm"


class Method:
    def __init__(self, config: dict, traffic: dict, data: dict, device):
        self.preset = config["presets"][PRESET]
        self.iterations = traffic["iterations"]
        self.cfg = TriTDConfig(**self.preset, max_iter=self.iterations, tol=traffic["tol"], dtype=config["dtype"])
        self.observed = data["observed"]
        self.instance = data.get("instance", list(range(len(self.observed))))
        self.origin = data["truth"] if config["origin"] else None
        self.shape = tuple(config["shape"])
        self.dtype = getattr(torch, config["dtype"])
        self.init = self.draw_init(config["data_seed"], "init", device)

    def draw_init(self, data_seed: int, tag: str, device) -> tuple:
        """The factor init (a0, b0, c0), standard normal, from `data_seed`."""
        seed = int.from_bytes(hashlib.sha256(f"{data_seed}:{tag}".encode()).digest()[:8], "little") >> 1
        gen = torch.Generator(device=device).manual_seed(seed)
        (n1, n2, n3), r = self.shape, self.cfg.rank
        return tuple(torch.randn(s, generator=gen, device=device, dtype=self.dtype)
                     for s in ((n1, r, r), (r, n2, r), (r, r, n3)))

    def inputs(self, i: int, gen: torch.Generator) -> dict:
        k = i % len(self.observed)
        return {"d": self.observed[k], "init": self.init, "instance": self.instance[k]}

    def solve(self, inp: dict) -> dict:
        res = tritd_admm(inp["d"], self.cfg, init=inp["init"], origin=self.origin)
        out = {"a": res.a, "b": res.b, "c": res.c, "o": res.o, "e": res.e, "err_hist": res.err_hist}
        if self.origin is not None:
            out["rre_hist"] = res.rre_hist
        return out

    @staticmethod
    def finite(out: dict) -> torch.Tensor:
        """A 0-d bool on the device: the error history is finite (it is made
        of the residuals' norms, so O, E and the factors are too)."""
        return torch.isfinite(out["err_hist"]).all()

    def reference(self, inp: dict, dtype: torch.dtype = torch.float64, tf32: bool = False) -> dict:
        return reference.solve(inp["d"], inp["init"], self.preset, self.iterations, origin=self.origin,
                               dtype=dtype, tf32=tf32)

    @staticmethod
    def compare(out: dict, ref: dict) -> dict:
        """The relative Frobenius gaps of O and E: the block's outputs, made
        from L, so from the mode solves, the annealing and the loop too. The
        factors and the histories are not compared: on the card at taxi over
        12 seeds the program's widest factor gap (3.2e-4, the ridge leaving
        near-flat gauge directions) and history gaps (err 8.6e-5, RRE
        3.6e-5, each one early iteration) reach within 1-3x of the TF32
        control's smallest, where O's stay 30x apart."""
        return {"o": relative_gap(out["o"], ref["o"]), "e": relative_gap(out["e"], ref["e"])}
