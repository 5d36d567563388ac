"""What a `torch.profiler` trace of the window says: the device's records,
the traced window, and the host's activity in the device's idle gaps.

The window is the span of the traced solves, from the first one's call to
the synchronize after the last, on the trace's own clock, so numerator and
denominator of every share come from one trace. Busy time is the union of
the device records' intervals clipped to the window, not their sum:
records that overlap count once.
"""

from __future__ import annotations

import dataclasses

SOLVE_SPAN = "benchmark.solve"
NOT_KERNELS = ("Memcpy", "Memset")


@dataclasses.dataclass
class Trace:
    device: list   # (name, start_us, end_us) of every device record
    host: list     # (name, start_us, end_us) of every host record
    solves: int    # solves traced
    iterations: int  # iterations traced (solves x iterations a solve)

    def __post_init__(self):
        spans = [(s, e) for name, s, e in self.host if name == SOLVE_SPAN]
        if len(spans) != self.solves:
            raise RuntimeError(f"the trace holds {len(spans)} solve spans for {self.solves} traced solves")
        self.start = min(s for s, _ in spans)
        self.end = max(e for _, e in spans)
        self.device = [(n, max(s, self.start), min(e, self.end)) for n, s, e in self.device
                       if e > self.start and s < self.end]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def kernels(self) -> list:
        return [ev for ev in self.device if not ev[0].startswith(NOT_KERNELS)]

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device records' intervals, in order."""
        merged: list[list[float]] = []
        for _n, s, e in sorted(self.device, key=lambda ev: ev[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def gaps(self) -> list[tuple[float, float]]:
        """The window's intervals in which no device record ran."""
        out, at = [], self.start
        for s, e in self.busy():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.end > at:
            out.append((at, self.end))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        the innermost host record open at each gap's middle (summed over
        gaps, with their count), both in seconds."""
        ops: dict[str, float] = {}
        for name, s, e in self.device:
            ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
        host = sorted(self.host, key=lambda ev: ev[1])
        idle: dict[str, list] = {}
        open_, nxt = [], 0
        for gs, ge in self.gaps():  # in order, so a record closed before one gap's middle stays closed
            mid = (gs + ge) / 2
            while nxt < len(host) and host[nxt][1] <= mid:
                open_.append(host[nxt])
                nxt += 1
            open_ = [ev for ev in open_ if ev[2] > mid]
            label = open_[-1][0] if open_ else "no host record"  # the latest opened: the innermost
            entry = idle.setdefault(label, [0.0, 0])
            entry[0] += (ge - gs) / 1e6
            entry[1] += 1
        return {"device_ops": [[n, v] for n, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
                "idle_gaps": [[f"{n} ({c} gaps)", v]
                              for n, (v, c) in sorted(idle.items(), key=lambda kv: -kv[1][0])[:top]]}


def from_profiler(prof, solves: int, iterations: int) -> Trace:
    """The Trace of a finished `torch.profiler.profile`."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.events():
        rec = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type != DeviceType.CUDA:
            host.append(rec)
        elif not getattr(ev, "is_user_annotation", False):  # a host span's shadow on the device's track
            device.append(rec)
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    return Trace(device, host, solves, iterations)
