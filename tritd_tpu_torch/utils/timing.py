"""Phase timing and device-synchronized clocks.

PyTorch counterpart of `tritd_tpu/utils/timing.py`. The reference's
observability is tic/toc around solver calls
(`traffic_triple_comparison.m:52,61`). PyTorch returns before a CUDA device
has finished, so the timers here wait for the device (`sync`) or time on it
with CUDA events (`device_timer`); a PhaseTimer accumulates named phases
(build/solve/elementwise/collective) like SOFIA's `info` struct
(`sofia.m:121-138`).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def iter_tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from iter_tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from iter_tensors(v)


def sync(tree):
    """Wait until every tensor in the nest (tuples, lists, dicts, named
    tuples) is computed: one `torch.cuda.synchronize` per CUDA device the
    tensors lie on. Returns the nest."""
    for device in {t.device for t in iter_tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)
    return tree


@contextlib.contextmanager
def device_timer(device=None):
    """`with device_timer(device) as t: ...` then `t()` -> seconds. On a CUDA
    device the time is taken between two CUDA events on its current stream,
    and `t()` waits for the second; on the CPU (or None) it is the host
    clock, which `t()` also reads while the block runs."""
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        begin = time.perf_counter()
        stop = {}
        yield lambda: stop.get("s", time.perf_counter() - begin)
        stop["s"] = time.perf_counter() - begin
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    stream = torch.cuda.current_stream(device)

    def elapsed():
        end.synchronize()  # raises if the block has not ended
        return start.elapsed_time(end) / 1e3

    start.record(stream)
    yield elapsed
    end.record(stream)


class PhaseTimer:
    """Host seconds and counts per named phase; a phase that is handed its
    outputs waits for their devices before it stops the clock."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, tree_to_sync=None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if tree_to_sync is not None:
                sync(tree_to_sync)
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def summary(self) -> dict[str, float]:
        return dict(self.totals)


@contextlib.contextmanager
def profiler_trace(log_dir: str = "/tmp/tritd_profile"):
    """`torch.profiler` trace of the block (host and, where there is one, the
    CUDA device); on exit the Chrome trace is written to
    `log_dir/trace.json`. Yields the profiler, whose `key_averages()` sums
    device time by kernel."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_fn(fn, *args, warmup: int = 1, iters: int = 3, **kwargs):
    """(best seconds, last result) of fn, its outputs' devices waited for;
    the warm-up calls take library set-up out of the times."""
    result = None
    for _ in range(max(warmup, 1)):
        result = sync(fn(*args, **kwargs))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        result = sync(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return best, result
