"""The sharded solve on both forms of the loop, for
tests/test_torch_sharded_device_loop.py: `routes` runs one rank's shard on
the eager loop (`run_admm` over gloo) and on the device form's blocks
without graphs (`admm._run_device_form(..., graphs=False, shard=...)`), each
through `sharded_admm._local_solve` as `tritd_admm_sharded` calls it. Run as
a module, it is one gloo/CPU rank that does so for every case of a .npz and
writes its own results:

    python -m torch_sharded_device_loop_worker --rank R --world-size W \\
        --init-method file://... --cases cases.npz --out out.npz

`cases.npz` holds `spec`, a JSON object {case: {cfg, mode}}, and per case
the arrays `case/d`, `case/a0`, `case/b0`, `case/c0` and, where the case has
them, `case/mask` and `case/origin`; rank r writes `out.npz.r<r>.npz`.
Imports no JAX."""

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

from tritd_tpu_torch.parallel import sharded_admm
from tritd_tpu_torch.parallel.distributed import initialize_distributed
from tritd_tpu_torch.solvers import TriTDConfig, admm

ROUTES = ("eager", "device")
STATE_FIELDS = ("a", "b", "c", "o", "e", "y_l", "y_o", "t", "err_hist", "rre_hist", "done")


def _device_form(d, state, cfg, mask=None, origin=None, norm_d=None, norm_origin=None, shard=None, _eager=False):
    """`run_admm`'s call, answered by the device form's blocks without graphs."""
    return admm._run_device_form(d, state, cfg, mask, origin, norm_d, norm_origin, graphs=False, shard=shard)


def routes(d, cfg, group, mode, mask, origin, init) -> dict:
    """route -> (final state, full-size result, audit) of this rank's shard."""
    out = {}
    real = sharded_admm.run_admm
    for route in ROUTES:
        coll = sharded_admm.SlabCollective(group, mode)
        sharded_admm.run_admm = _device_form if route == "device" else real
        try:
            state, bounds, audit = sharded_admm._local_solve(d, cfg, coll, mask, origin, init, torch.device("cpu"))
        finally:
            sharded_admm.run_admm = real
        out[route] = (state, sharded_admm._result(state, cfg, mode, bounds, group), audit)
    return out


def arrays_of(key: str, result: dict) -> dict:
    """The .npz entries of `routes`' result for case `key`; a bfloat16
    field as its bits (int16), which numpy holds."""
    out = {}
    for route, (state, full, audit) in result.items():
        for f in STATE_FIELDS:
            x = getattr(state, f)
            out[f"{key}/{route}/{f}"] = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
        out[f"{key}/{route}/mu"] = np.array([state.mu_l, state.mu_o])
        out[f"{key}/{route}/k"] = np.array(state.k)
        out[f"{key}/{route}/o_full"] = full.o.numpy()
        out[f"{key}/{route}/audit"] = np.array(json.dumps({k: audit[k] for k in ("setup", "per_iter", "n_iters")}))
    return out


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--init-method", required=True)
    p.add_argument("--cases", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    torch.set_num_threads(1)
    rank, _world = initialize_distributed(args.init_method, args.world_size, args.rank, backend="gloo",
                                          device="cpu", timeout_s=120.0)
    try:
        with np.load(args.cases) as f:
            arrays = dict(f)
        spec = json.loads(str(arrays.pop("spec")))
        out = {}
        for key, case in spec.items():
            init = tuple(arrays[f"{key}/{k}"] for k in ("a0", "b0", "c0"))
            d, mask, origin = (arrays.get(f"{key}/{k}") for k in ("d", "mask", "origin"))
            out.update(arrays_of(key, routes(d, TriTDConfig(**case["cfg"]), dist.group.WORLD, case["mode"], mask,
                                             origin, init)))
        np.savez(f"{args.out}.r{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
