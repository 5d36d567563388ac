"""Kernel records (memory copies and sets left out) in the traced window
over the iterations run in it: the launches of `solvers/admm.py`'s loop,
its graph replays' kernels and each call's eager and captured work."""


def read(ctx):
    if ctx.trace is None:
        return None
    return len(ctx.trace.kernels()) / ctx.trace.iterations
