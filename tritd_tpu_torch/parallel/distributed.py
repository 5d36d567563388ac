"""Multi-process bootstrap: `torch.distributed` process group + meshes, and
a runnable worker for one rank of a distributed solve.

PyTorch counterpart of `tritd_tpu/parallel/distributed.py`. Design:

  * one process per device; `initialize_distributed` joins it to the
    process group (`dist.init_process_group`, the counterpart of
    `jax.distributed.initialize`);
  * a 2-D mesh ("data", "slab") over all ranks. `make_host_chip_mesh` puts
    hosts on the first axis and each host's devices on the second, so a
    collective along "slab" stays inside a host (NVLink) and
    `tritd_admm_batch_sharded` runs DP across hosts x TP within one;
    `make_global_slab_mesh` puts every rank on the slab axis, host-major.
    Per iteration the traffic is the O(r^4 + n r^2) words of
    `parallel/sharded_admm.py` either way;
  * every process is given the same host tensor and keeps its own slab.

Device and backend are explicit, and nothing picks another when the asked
one fails. `--device` defaults to `cuda` (rank r takes `cuda:{LOCAL_RANK}`),
`--backend` to `nccl` for CUDA and `gloo` for `cpu`. NCCL wants one GPU per
rank; several ranks on one card (`--device cuda:0`) go over `gloo`, which
reduces CUDA tensors through the host. That is how one card runs the
sharded program; its ranks are time-sliced, so it measures no scaling.

Run one rank of a distributed solve by hand (all ranks at once, each in its
own shell or in the background; rank 0 writes the .npz):

  python -m tritd_tpu_torch.parallel.distributed --rank 0 --world-size 2 \\
      --init-method tcp://127.0.0.1:29500 --out /tmp/run.npz          # nccl, cuda:{LOCAL_RANK}
  python -m tritd_tpu_torch.parallel.distributed --rank 0 --world-size 2 \\
      --init-method tcp://127.0.0.1:29500 --backend gloo --device cpu

The worker draws its problem with numpy from `--seed`
(:func:`build_problem`), so every rank, and a process that checks the result
against a single-device solve, builds the same tensors.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..data import load_dataset, random_tritd, sparse_outliers, uniform_missing_mask
from ..data.loaders import DATASETS
from ..ops import hopper_kernels
from ..solvers.admm import init_factors
from ..solvers.base import TriTDConfig
from ..utils.config import COMPLETION_TRITD, README_MISSING_RATIO, VIDEO_TRITD
from ..utils.timing import sync
from .mesh import AXES, make_mesh
from .sharded_admm import tritd_admm_batch_sharded, tritd_admm_sharded

SYNTHETIC_MISSING_RATIO = 0.15


def rank_device(device: str, rank: int) -> torch.device:
    """The device a rank works on. `cuda` alone means `cuda:{LOCAL_RANK}`
    (the launcher's environment variable; the rank itself on one host);
    `cuda:i` and `cpu` are taken as they are. Raises without CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {device}: torch.cuda.is_available() is False; ask for --device cpu "
                               "to run the plain path")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return dev


def initialize_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    device: str = "cuda",
    timeout_s: float = 300.0,
) -> tuple[int, int]:
    """Join this process to the default process group. With no
    `init_method` the launcher's environment (`MASTER_ADDR`, `MASTER_PORT`,
    `RANK`, `WORLD_SIZE`, as `torchrun` sets them) is read. `backend`
    defaults to `nccl` for a CUDA device and `gloo` for the CPU; a CUDA
    device becomes the process's current device first. Every collective
    waits at most `timeout_s`. Returns (rank, world_size)."""
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://", rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return dist.get_rank(), dist.get_world_size()


def make_host_chip_mesh(axis_names: tuple[str, str] = AXES, local_world_size: int | None = None,
                        device_type: str = "cuda"):
    """2-D mesh with hosts on the first axis and each host's ranks on the
    second, ranks numbered host-major. `local_world_size` defaults to the
    launcher's `LOCAL_WORLD_SIZE`."""
    from torch.distributed.device_mesh import init_device_mesh

    if local_world_size is None:
        if "LOCAL_WORLD_SIZE" not in os.environ:
            raise ValueError("make_host_chip_mesh needs local_world_size or the LOCAL_WORLD_SIZE variable")
        local_world_size = int(os.environ["LOCAL_WORLD_SIZE"])
    world = dist.get_world_size()
    if world % local_world_size:
        raise ValueError(f"{world} ranks are not whole hosts of {local_world_size}")
    return init_device_mesh(device_type, (world // local_world_size, local_world_size), mesh_dim_names=axis_names)


def make_global_slab_mesh(device_type: str = "cuda"):
    """Mesh with every rank of every host on the "slab" axis, host-major, so
    mode-1 slabs lie contiguously per host."""
    return make_mesh(n_data=1, device_type=device_type)


# ----------------------------------------------------------------------------
# Runnable worker: one rank of a distributed TriTD solve.
# ----------------------------------------------------------------------------


def build_problem(dataset: str | None = None, shape=(22, 13, 17), rank: int = 2, max_iter: int = 25, seed: int = 0,
                  masked: bool = False, storage_dtype: str | None = None, batch: int = 0) -> dict:
    """The worker's problem, from numpy draws alone: `d`, `mask`, `origin`
    (each with the batch axis first when `batch` > 0, entry i from seed + i)
    and `cfg`.

    No dataset: a random TriTD tensor of `shape` and `rank` plus 5% outliers
    of magnitude 4 (the reference worker's problem). A traffic dataset: its
    stand-in with 10% of entries missing and zero-filled, under the
    completion preset; a video dataset: fully observed, under the video
    preset. `origin` is the clean tensor. With `masked` the observed mask
    goes to the solver (15% missing for the synthetic problem). tol is 0, as
    in the reference worker: every run does `max_iter` iterations, so
    histories compare entry by entry and rates run by run (at the presets'
    tol the stop rule fires on the float32 floor of err_hist, where the
    order of sums decides the iteration)."""
    def one(s):
        rng = np.random.default_rng(s)
        if dataset is None:
            x, _ = random_tritd(rng, tuple(shape), rank)
            d = x + sparse_outliers(rng, tuple(shape), 0.05, 4.0)
            mask = uniform_missing_mask(rng, tuple(shape), SYNTHETIC_MISSING_RATIO) if masked else None
        else:
            x, spec, _prov = load_dataset(dataset)
            d = x = np.asarray(x, np.float32)
            mask = None
            if spec.kind == "traffic":
                mask = uniform_missing_mask(rng, x.shape, README_MISSING_RATIO)
        if mask is not None:
            d = np.where(mask, d, 0.0).astype(np.float32)
        return d, mask if masked else None, x

    if dataset is None:
        cfg = TriTDConfig(rank=rank, max_iter=max_iter, tol=0.0)
    else:
        preset = COMPLETION_TRITD if DATASETS[dataset].kind == "traffic" else VIDEO_TRITD
        cfg = dataclasses.replace(preset, max_iter=max_iter, tol=0.0)
    if masked and dataset is not None and DATASETS[dataset].kind != "traffic":
        raise ValueError(f"--masked: the {dataset} stand-in is fully observed")
    cfg = dataclasses.replace(cfg, masked=masked, storage_dtype=storage_dtype)
    entries = [one(seed + i) for i in range(max(batch, 1))]
    if batch:
        d, mask, origin = (None if f[0] is None else np.stack(f) for f in zip(*entries))
    else:
        d, mask, origin = entries[0]
    return {"d": d, "mask": mask, "origin": origin, "cfg": cfg}


def batch_init(nb: int, shape, rank: int, dtype: torch.dtype):
    """The default init of `tritd_admm_batch_sharded`, entry by entry, as
    a list of (a0, b0, c0): what a single-device check starts from."""
    gen = torch.Generator().manual_seed(0)
    return [init_factors(gen, tuple(shape), rank, dtype, "cpu") for _ in range(nb)]


def _gather_rows(row: torch.Tensor) -> torch.Tensor:
    """Every rank's `row`, stacked by rank, on every rank: a zero-filled
    buffer summed over the world (gloo gathers no CUDA tensors)."""
    full = torch.zeros((dist.get_world_size(), *row.shape), dtype=row.dtype, device=row.device)
    full[dist.get_rank()] = row
    dist.all_reduce(full)
    return full


def _worker(args) -> None:
    device = rank_device(args.device, args.rank)
    rank, world = initialize_distributed(
        init_method=args.init_method, world_size=args.world_size, rank=args.rank,
        backend=args.backend, device=args.device, timeout_s=args.timeout_s,
    )
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        shape = tuple(int(v) for v in args.shape.split(","))
        prob = build_problem(args.dataset, shape, args.rank_r, args.max_iter, seed=args.seed, masked=args.masked,
                             storage_dtype=args.storage_dtype, batch=args.batch)
        cfg = prob["cfg"]
        mesh = make_mesh(n_data=args.n_data, device_type=device.type)

        def run(origin=prob["origin"]):
            audit: dict = {}
            if args.batch:
                res = tritd_admm_batch_sharded(prob["d"], cfg, mesh, mask_batch=prob["mask"], origin_batch=origin,
                                               device=device, audit=audit)
            else:
                res = tritd_admm_sharded(prob["d"], cfg, mesh, shard_tensor_mode=args.shard_mode, mask=prob["mask"],
                                         origin=origin, device=device, audit=audit)
            return sync(res), audit

        hopper_kernels.reset_launch_counts()
        res, audit = run()
        counts = hopper_kernels.BATCH_LAUNCHES if args.batch else hopper_kernels.LAUNCHES
        names = sorted(counts)
        launches = _gather_rows(torch.tensor([counts[n] for n in names], device=device))
        # the replicated solves must have stayed replicated: rank 0's factors
        # against everyone's, the largest difference over all ranks
        diffs = []
        for f in (res.a, res.b, res.c):
            ref = f.clone()
            dist.broadcast(ref, src=0)
            diffs.append((f - ref).abs().max())
        replica_diff = torch.stack(diffs).max()
        dist.all_reduce(replica_diff, op=dist.ReduceOp.MAX)

        best = None
        for _ in range(args.bench_repeats):
            _res, timed = run(origin=None)
            loop_s = torch.tensor(timed["loop_seconds"], dtype=torch.float64, device=device)
            dist.all_reduce(loop_s, op=dist.ReduceOp.MAX)  # the slowest rank's loop
            best = float(loop_s) if best is None else min(best, float(loop_s))
        if best is not None and rank == 0:
            print(json.dumps({
                "n_shards": world // args.n_data, "n_data": args.n_data, "world_size": world,
                "backend": dist.get_backend(), "device": str(device),
                "iters_per_s": timed["steps" if args.batch else "n_iters"] / best, "seconds": best,
                "n_iters": timed["n_iters"],
            }), flush=True)

        if args.out and rank == 0:
            np.savez(
                args.out,
                err_hist=res.err_hist.cpu().numpy(), rre_hist=res.rre_hist.cpu().numpy(),
                n_iters=np.asarray(torch.as_tensor(res.n_iters).cpu()),
                world_size=world, n_data=args.n_data, backend=dist.get_backend(), device=str(device),
                launch_names=np.array(names), launches=launches.cpu().numpy(),
                replica_max_diff=float(replica_diff),
                all_reduce_calls_per_iter=audit["per_iter"]["calls"],
                all_reduce_words_per_iter=audit["per_iter"]["words"],
                all_reduce_bytes_per_iter=audit["per_iter"]["bytes"],
                all_reduce_setup_words=audit["setup"]["words"],
                loop_seconds=audit["loop_seconds"],
                best_loop_seconds=np.nan if best is None else best,
            )
    finally:
        dist.destroy_process_group()


def launch_local(world_size: int, worker_args: list[str], timeout_s: float = 600.0,
                 module: str = "tritd_tpu_torch.parallel.distributed", env: dict | None = None) -> list[str]:
    """Run `world_size` workers on this host, rank 0 to world_size - 1:
    `python -m module --rank r --world-size W --init-method file://...`
    (a file store in a temporary directory) followed by `worker_args`, in
    the environment `env` (default: this process's) with this package on
    the path. Waits at most `timeout_s`; if a worker fails or the time runs
    out, the others are killed and a RuntimeError carries every worker's
    output. Returns the outputs by rank."""
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(world_size)]
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", module, "--rank", str(r),
                 "--world-size", str(world_size), "--init-method", f"file://{tmp}/rendezvous", *worker_args],
                stdout=logs[r], stderr=subprocess.STDOUT, env=env,
            )
            for r in range(world_size)
        ]
        deadline = time.monotonic() + timeout_s
        try:
            # a rank that died leaves its peers waiting in a collective: stop
            # at the first failure, not at the collective's own time limit
            while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
                if any(p.returncode for p in procs):
                    break
                time.sleep(0.05)
        finally:
            unfinished = [r for r, p in enumerate(procs) if p.poll() is None]
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            texts = []
            for f in logs:
                f.seek(0)
                texts.append(f.read())
                f.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        failed = any(c for r, c in enumerate(codes) if r not in unfinished)
        why = "a worker failed" if failed else f"no end within {timeout_s:.0f} s"
        raise RuntimeError(f"{world_size} workers, {why}; exit codes {codes}\n" + "\n".join(
            f"--- rank {r} ---\n{t}" for r, t in enumerate(texts)))
    return texts


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rank", type=int, required=True, help="this process's rank in the group")
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--init-method", default="tcp://127.0.0.1:12355", help="tcp://host:port or file:///path")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl for a CUDA device, gloo for cpu")
    p.add_argument("--device", default="cuda", help="cuda (= cuda:{LOCAL_RANK}), cuda:i or cpu")
    p.add_argument("--timeout-s", type=float, default=300.0, help="limit of every collective")
    p.add_argument("--shape", default="22,13,17", help="shape of the synthetic problem")
    p.add_argument("--rank-r", type=int, default=2, help="TriTD rank of the synthetic problem")
    p.add_argument("--max-iter", type=int, default=25)
    p.add_argument("--shard-mode", type=int, default=1, choices=(1, 3))
    p.add_argument("--dataset", default=None, choices=sorted(DATASETS),
                   help="a dataset's stand-in under its preset, in place of the synthetic problem")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--masked", action="store_true", help="masked imputation (cfg.masked)")
    p.add_argument("--storage-dtype", default=None,
                   help="cfg.storage_dtype: bfloat16, float16, float8_e4m3fn or float8_e5m2")
    p.add_argument("--n-data", type=int, default=1, help="size of the mesh's data axis")
    p.add_argument("--batch", type=int, default=0,
                   help="solve a batch of this many problems (seeds seed, seed+1, ...) with tritd_admm_batch_sharded")
    p.add_argument("--out", default=None, help="rank 0 writes the histories and counts to this .npz")
    p.add_argument("--bench-repeats", type=int, default=0)
    _worker(p.parse_args(argv))


if __name__ == "__main__":
    main()
