"""One rank of the parallel parity tests (tests/test_torch_parallel.py): a
gloo/CPU process that runs every case of its world size through the port's
sharded solvers and, on rank 0, writes the histories to one .npz.

    python -m torch_parallel_worker --rank R --world-size W --init-method file://... \\
        --cases cases.npz --out out.npz

`cases.npz` holds `spec`, a JSON object {case: {cfg, mode, n_data, batch, auto}},
and per case the arrays `case/d`, `case/a0`, `case/b0`, `case/c0` and, where
the case has them, `case/mask` and `case/origin`. Imports no JAX."""

import argparse
import json

import numpy as np
import torch

from tritd_tpu_torch.parallel import make_mesh, tritd_admm_auto, tritd_admm_batch_sharded, tritd_admm_sharded
from tritd_tpu_torch.parallel.distributed import initialize_distributed
from tritd_tpu_torch.solvers import TriTDConfig


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
        meshes, out = {}, {}
        for name, case in spec.items():
            n_data = case["n_data"]
            if n_data not in meshes:
                meshes[n_data] = make_mesh(n_data=n_data, device_type="cpu")
            cfg = TriTDConfig(**case["cfg"])
            init = tuple(arrays[f"{name}/{k}"] for k in ("a0", "b0", "c0"))
            d, mask, origin = (arrays.get(f"{name}/{k}") for k in ("d", "mask", "origin"))
            audit: dict = {}
            if case["batch"]:
                res = tritd_admm_batch_sharded(d, cfg, meshes[n_data], mask_batch=mask, origin_batch=origin,
                                               init=init, audit=audit, data_axis="data", slab_axis="slab")
            elif case["auto"]:
                res = tritd_admm_auto(d, cfg, meshes[n_data], axis_name="slab", mask=mask, origin=origin,
                                      init=init, audit=audit)
            else:
                res = tritd_admm_sharded(d, cfg, meshes[n_data], shard_tensor_mode=case["mode"], mask=mask,
                                         origin=origin, init=init, audit=audit, axis_name="slab")
            for field in ("a", "b", "c", "o", "e", "err_hist", "rre_hist", "n_iters"):
                out[f"{name}/{field}"] = np.asarray(torch.as_tensor(getattr(res, field)))
            out[f"{name}/words_per_iter"] = audit["per_iter"]["words"]
        if rank == 0:
            np.savez(args.out, **out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
