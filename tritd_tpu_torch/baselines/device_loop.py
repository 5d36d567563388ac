"""The SVT baselines' fixed-count loops (`tt_trpca`, `rtrc`, `rc_fctn`) as
the reference runs them: one device program, no read to the host between
two iterations.

The reference's loops are `lax.fori_loop`s (`tritd_tpu/baselines/ttnn.py`,
`rtrc.py`, `rc_fctn.py`), their penalties and histories on the device. Here
one iteration is `step(k, carry, refresh) -> fields`, the next values of
the carried fields it changes, with `k` the iteration, `refresh` whether a
warm route recomputes its bases (`ops/svt.py::run_warm_blocks`'s schedule,
None off the warm route). :func:`run` drives it along one of three routes
(`ops/toolbox_loop.py`'s, `forced_route` included):

* `None`, the host loop (the CPU's): `k` a host int, the carry a dict of
  tensors replaced each iteration, as the loops ran before.
* `False`, the device form without graphs (`solvers.admm._DeviceLoop` with
  no stop): `k` the 0-d counter on the device, the carried fields copied in
  place into contiguous buffers, the counter read once at the end of each
  segment (on the card with the Jacobi SVD's count of calls that stopped
  at its cap of sweeps unconverged, in the same read: a segment that adds
  to it raises, as `torch.linalg.svd` raises where its SVD fails to
  converge).
* `True`, the device form with graphs (a CUDA device): the same, each
  iteration a CUDA graph replay, one graph a kind of iteration (refresh or
  reuse), each kind's first iteration eager on the side stream. Where a
  graph cannot capture the loop's SVT (:func:`route`), the card takes the
  host loop instead.

The host scalars of an iteration (the grown penalties, their quotients) come
from :class:`Scalars`: computed on the host for every iteration before the
loop, as the host loop computes them, and read on the device by the counter.
A Python float meets a tensor as that float rounded to the tensor's dtype,
which the table holds, so on the CPU the two forms give the same bits. On
the card they differ from each other in the last bit where a tensor is
divided by a penalty: CUDA multiplies by a host number's reciprocal there,
and divides by a device number.
"""

from __future__ import annotations

import torch

from ..ops import device_linalg, svt as svt_ops, toolbox_loop
from ..solvers import admm


class Scalars:
    """The host scalars of every iteration: `rows[k]` a dict name -> float,
    and the same as a (n, names) table in `dtype` on `device`. `at(k)`
    gives iteration k's: the host floats for a host int k, 0-d views of the
    table's row for a device counter k (one index launch, no read back)."""

    def __init__(self, rows: list[dict], dtype: torch.dtype, device):
        self.rows = rows
        self.names = tuple(rows[0]) if rows else ()
        self.table = torch.tensor([[row[n] for n in self.names] for row in rows], dtype=dtype, device=device)

    def at(self, k):
        if not isinstance(k, torch.Tensor):
            return self.rows[k]
        row = self.table.index_select(0, k.reshape(1))[0]
        return {name: row[i] for i, name in enumerate(self.names)}


def route(device: torch.device, svt_method: str, shapes) -> bool | None:
    """The route of a baseline's loop on `device` (`toolbox_loop.route`),
    but the eager host loop where a CUDA graph cannot capture the SVT route
    on the loop's unfoldings, of `shapes` (`svt.captures`: an SVD of a thin
    side past `device_linalg.SVD_JACOBI_MAX_K`, an eigh past n = 512),
    chosen before any capture."""
    return toolbox_loop.route(device, svt_ops.captures(svt_method, shapes))


def schedule(max_iter: int, chunk: int, period: int | None) -> list:
    """The refresh flag of each iteration, chunk by chunk: each chunk a
    new `run_warm_blocks` block; None for every iteration off the warm
    route (`period` None)."""
    if period is None:
        return [None] * max_iter
    return [r for k0 in range(0, max_iter, chunk) for r in svt_ops._refresh_schedule(min(chunk, max_iter - k0), period)]


def write(hist: torch.Tensor, k, value: torch.Tensor) -> None:
    """hist[k] = value in place, for a host int or a device counter k."""
    admm._write(hist, k, value)


def run(step, carry: dict, kinds: list, segments, graphs: bool | None) -> dict:
    """Runs `step` for the iterations of `kinds` (one entry each: the
    refresh flag, or None) from `carry` (name -> tensor), on the route
    `graphs`; the device forms advance their loop to each end of
    `segments` in turn (one read of the counter each). Returns the carry
    after the last iteration: on the device forms the loop's own buffers."""
    max_iter = len(kinds)
    if graphs is None:
        for k, refresh in enumerate(kinds):
            carry = {**carry, **step(k, carry, refresh)}
        return carry
    if not max_iter:
        return carry
    device = next(iter(carry.values())).device
    fixed = {name: toolbox_loop.fixed(x) for name, x in carry.items()}
    fixed["k"] = torch.zeros((), dtype=torch.int64, device=device)

    def iteration(c: dict, _data, _out, refresh) -> dict:
        return {**step(c["k"], c, refresh), "k": c["k"] + 1}

    loop = _Loop(iteration, fixed, (), max_iter, device, graphs, stops=False, kinds=lambda k: kinds[k])
    for end in segments:
        fixed, _data = loop.advance(end)
    return {name: fixed[name] for name in carry}


class _Loop(admm._DeviceLoop):
    """The device form of :func:`run`; on the card its end-of-segment read
    also reads how many of the segment's Jacobi SVDs stopped at their cap
    (`device_linalg.jacobi_capped`, against its value at the segment's
    start, copied on the device), and raises if any did: the segment's
    SVDs, its eager first iterations' too, read nothing themselves."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        device = self.carry["k"].device
        self.capped = device_linalg.jacobi_capped(device) if device.type == "cuda" else None

    def advance(self, k_end: int):
        if self.capped is None:
            return super().advance(k_end)
        self.capped_before = self.capped.clone()
        with device_linalg.caller_reads_the_cap():  # the eager first iterations read nothing either
            return super().advance(k_end)

    def _result(self):
        if self.capped is None:
            return super()._result()
        k, capped = torch.stack((self.carry["k"], (self.capped - self.capped_before).to(torch.int64))).tolist()
        if capped:
            raise RuntimeError(f"{capped} Jacobi SVD call(s) of this segment stopped at "
                               f"{device_linalg.JACOBI_SWEEPS} sweeps without converging")
        if k != self.k:
            raise AssertionError(f"the counter on the device reads {k} after {self.k} iterations")
        return self.carry, self._data(self.n_done)
