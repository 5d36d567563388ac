"""The Tensor Toolbox's solver loops in the reference's form: a
`lax.while_loop` whose `cond` is `it < max_iters & quantity >= tol`, run on
the device with no read to the host but the stop flag.

One loop is an `iteration(carry) -> (fields, quantity)`: the next values of
the carried fields (factors, fit, eigenpair, Adam state, ...) and the
quantity the stop tests. :func:`run` carries them in fixed tensors, beside
the 0-d counter `k` and flag `done = ~(quantity >= tol)` (a NaN stops the
loop, as it stops the reference's; the comparison is in the quantity's
dtype, as the reference's weakly typed `tol` is), along one of three
routes:

* `None`, the host loop (the CPU's): the fields are copied into the carry
  after each iteration and the flag read back once an iteration.
* `False`, the device form without graphs (`solvers.admm._DeviceLoop`):
  the same iterations, the flag read once a block of one iteration, the
  device's counter read once at the end and returned as `n_iters`.
* `True`, the device form with graphs (a CUDA device): the first
  iteration runs eagerly on a side stream, every later one is the replay of
  one CUDA graph (`admm._Stepper`); a capture that fails raises.

On a CUDA tensor the graph route is the default, as `admm._graph_route`
chooses for the TriTD loops; elsewhere the host loop. :func:`forced_route`
makes every loop inside it take another route, to compare the routes. A
carried field is copied into its tensor in place, so a closure that reads
one (`adam_descent`'s objective reads the parameters) reads the same
address on every replay.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch

_FORCED: contextvars.ContextVar = contextvars.ContextVar("toolbox_loop_route", default=())


@contextlib.contextmanager
def forced_route(graphs: bool | None):
    """Within: every Toolbox loop takes the route `graphs` (None the host
    loop, False the device form without graphs, True graphs), whatever its
    tensors' device. For the comparison of the routes."""
    token = _FORCED.set((graphs,))
    try:
        yield
    finally:
        _FORCED.reset(token)


def route(device: torch.device, captures: bool = True) -> bool | None:
    """The route of a loop on `device`: the forced one, else graphs on a
    CUDA device and the host loop elsewhere; but the host loop in place of
    graphs where an iteration makes a call that a CUDA graph cannot capture
    (`captures` False), chosen before any capture."""
    forced = _FORCED.get()
    graphs = forced[0] if forced else (True if device.type == "cuda" else None)
    return None if graphs and not captures else graphs


def fixed(x: torch.Tensor) -> torch.Tensor:
    """A carried field's tensor: a contiguous copy of `x`, which the loop
    then updates in place."""
    return x.detach().clone(memory_format=torch.contiguous_format)


def full(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of `value` in `like`'s dtype and device, made on the
    device (no copy from the host)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def run(iteration, carry: dict, max_iters: int, tol: float, captures: bool = True) -> tuple[dict, int]:
    """Runs `iteration` from `carry` (name -> tensor, each updated in place)
    while fewer than `max_iters` iterations ran and the last quantity was
    >= tol (at the start the quantity is +inf), on the route of
    :func:`route` (`captures`: whether a CUDA graph can capture the
    iteration); returns the carry (with `k` and `done`) and the iterations
    run."""
    device = next(iter(carry.values())).device
    carry = {**carry, "k": torch.zeros((), dtype=torch.int64, device=device),
             "done": torch.zeros((), dtype=torch.bool, device=device)}

    def step(c: dict, _data=(), _out=()) -> dict:
        fields, quantity = iteration(c)
        return {**fields, "k": c["k"] + 1, "done": ~(quantity >= tol)}

    if not (max_iters > 0 and math.inf >= tol):  # the cond at the entry
        return carry, 0
    graphs = route(device, captures)
    if graphs is None:
        it = 0
        while True:
            for name, value in step(carry).items():
                carry[name].copy_(value)
            it += 1
            if it == max_iters or bool(carry["done"]):
                return carry, it
    from ..solvers import admm  # here: the solvers import this package's modules

    loop = admm._DeviceLoop(step, carry, (), max_iters, device, graphs)
    carry, _data = loop.advance(max_iters)
    return carry, loop.k
