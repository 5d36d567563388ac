"""What the taxi `svd` rows of the SVT baselines take on the card, in this
tree or another: ttnn, ring and fctn with `svt_method="svd"` through
`cli.run_completion.run_method` at the taxi stand-in (10% missing, as
chip_smoke.py's phase 9 cuts it), float32, `--iters` iterations, ms an
iteration by events around the call (after a 2-iteration warm-up of the
same rows), the final RRE and the binding's calls, one JSON line a row,
for each tree in turns (`--tree . --tree results/parent --tree
results/parent --tree .` compares a parent in the same call), each in a
process of its own with DIR first on sys.path, so that DIR's package runs.
A parent without the Jacobi SVD runs these rows on gesvdj and the eager
loop.

With `--kernel`, instead, the Jacobi SVD alone
(`ops.device_linalg.jacobi_svd`) at the six taxi unfoldings (the taxi
stand-in's unfoldings at 10% missing, as phase 9 cuts them), float32 and
float64, beside `torch.linalg.svd` (gesvdj) on the same matrix: ms a call,
the median of `--turns` calls by events (gesvdj's of three), the sweeps of
a call, one JSON line an unfolding and dtype, for each tree in turns, in a
process of its own. `--unfoldings video` takes instead the video cut's (240 x 320 x 300): tt_trpca's 240 x
96000 and 76800 x 300 and ring's 96000 x 240 of the highway stand-in and of
its static clip (frame 0 repeated 300 times).

    python -m tritd_tpu_torch.tools.svd_rows --tree . [--tree results/parent] [--iters 100]
        [--kernel [--turns 5] [--unfoldings taxi|video]]

Needs a CUDA device (and nvcc, for the kernels' first build). Prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROW_METHODS = ("ttnn", "ring", "fctn")

_ROWS = r"""
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import tritd_tpu_torch
from tritd_tpu_torch.baselines.rtrc import precompute_freedom_ratio
from tritd_tpu_torch.cli.run_completion import run_method
from tritd_tpu_torch.data import load_dataset, uniform_missing_mask
from tritd_tpu_torch.metrics.recon import rre
from tritd_tpu_torch.ops import hopper_kernels
from tritd_tpu_torch.utils.config import README_MISSING_RATIO

torch.backends.cuda.matmul.allow_tf32 = False
iters, methods = int(sys.argv[2]), sys.argv[3].split(",")
x_np, spec, _prov = load_dataset("taxi")
mask = torch.as_tensor(uniform_missing_mask(np.random.default_rng(0), x_np.shape, README_MISSING_RATIO), device="cuda")
x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
y = torch.where(mask, x, torch.zeros_like(x))
precompute_freedom_ratio(y, mask)
for method in methods:  # the library's build and set-up outside the times
    run_method(method, y, x, mask, spec, torch.Generator().manual_seed(0), 2, svt_method="svd")
counts = [hopper_kernels.LINALG_CALLS] + [getattr(hopper_kernels, "JACOBI_SVD_LAUNCHES", {})]
for method in methods:
    hopper_kernels.reset_launch_counts()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    x_hat, _o, hist = run_method(method, y, x, mask, spec, torch.Generator().manual_seed(0), iters, svt_method="svd")
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    print("ROW " + json.dumps({"tree": sys.argv[1], "package": tritd_tpu_torch.__file__, "method": method,
                               "iters": iters, "ms_per_iter": ms / iters, "rre": float(rre(x_hat, x)),
                               "calls": {k: n for c in counts for k, n in c.items() if n}}), flush=True)
"""


_KERNEL = r"""
import json, statistics, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import tritd_tpu_torch
from tritd_tpu_torch.data import load_dataset, uniform_missing_mask
from tritd_tpu_torch.ops import device_linalg
from tritd_tpu_torch.utils.config import README_MISSING_RATIO

torch.backends.cuda.matmul.allow_tf32 = False
turns, unfoldings = int(sys.argv[2]), sys.argv[3]
if unfoldings == "taxi":
    x_np, _spec, _prov = load_dataset("taxi")
    mask = uniform_missing_mask(np.random.default_rng(0), x_np.shape, README_MISSING_RATIO)
    y = torch.as_tensor(np.where(mask, x_np, 0.0), dtype=torch.float32, device="cuda")
    n1, n2, n3 = y.shape
    fctn = y.reshape(n1, n2, n3 // 10, 10).permute(0, 2, 1, 3).reshape(n1 * n3 // 10, n2 * 10)
    mats = [("", m) for m in (y.reshape(n1, -1), y.reshape(-1, n3), y.permute(2, 0, 1).reshape(n3, -1),
                              y.permute(1, 2, 0).reshape(-1, n1), fctn, fctn.T)]
else:
    v_np, _spec, _prov = load_dataset("highway")
    v = torch.as_tensor(v_np, dtype=torch.float32, device="cuda")
    mats = [(clip, m) for clip, c in (("highway", v), ("static", v[:, :, :1].expand(v.shape).contiguous()))
            for m in (c.reshape(c.shape[0], -1), c.reshape(-1, c.shape[2]), c.permute(1, 2, 0).reshape(-1, c.shape[0]))]


def ms(call, n):
    call()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


for dtype in (torch.float32, torch.float64):
    for clip, m in mats:
        a = m.to(dtype).contiguous()
        print("ROW " + json.dumps({"tree": sys.argv[1], "package": tritd_tpu_torch.__file__,
                                   "unfolding": " ".join(filter(None, (clip, "x".join(map(str, a.shape))))),
                                   "dtype": str(dtype)[6:], "kernel_ms": ms(lambda: device_linalg.jacobi_svd(a), turns),
                                   "sweeps": int(device_linalg.jacobi_svd_with_sweeps(a)[3]),
                                   "gesvdj_ms": ms(lambda: torch.linalg.svd(a, full_matrices=False), 3)}), flush=True)
"""


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def rows(trees: list, iters: int, kernel: bool = False, turns: int = 5, unfoldings: str = "taxi") -> None:
    for tree in trees:
        args = [str(turns), unfoldings] if kernel else [str(iters), ",".join(ROW_METHODS)]
        proc = subprocess.run([sys.executable, "-c", _KERNEL if kernel else _ROWS, str(Path(tree).resolve()), *args],
                              capture_output=True, text=True, timeout=1800)
        got = [line[4:] for line in proc.stdout.splitlines() if line.startswith("ROW ")]
        if proc.returncode or len(got) != (12 if kernel else len(ROW_METHODS)):
            raise SystemExit(f"rows of {tree}: exit {proc.returncode}\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        for line in got:
            print(line, flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", help="a tree whose tritd_tpu_torch runs the rows (repeatable)")
    parser.add_argument("--iters", type=int, default=100)
    parser.add_argument("--kernel", action="store_true", help="the Jacobi SVD alone at the six taxi unfoldings")
    parser.add_argument("--turns", type=int, default=5, help="--kernel: timed calls a matrix")
    parser.add_argument("--unfoldings", choices=("taxi", "video"), default="taxi",
                        help="--kernel: the taxi stand-in's six or the video cut's three of two clips")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("svd_rows needs a CUDA device")
    print(_card(), flush=True)
    rows(args.tree or ["."], args.iters, args.kernel, args.turns, args.unfoldings)


if __name__ == "__main__":
    main()
