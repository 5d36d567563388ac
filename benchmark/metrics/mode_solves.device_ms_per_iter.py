"""Device time of every kernel record but the elementwise block's, over the
iterations traced, in ms: the mode solves (`ops/normal_eq.py`,
`ops/designs.py`), the reconstruction and the loop's small kernels."""

BLOCK_KERNEL = "elementwise_block_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    rest = [e - s for name, s, e in ctx.trace.kernels() if BLOCK_KERNEL not in name]
    if not rest:
        return None
    return sum(rest) / 1e3 / ctx.trace.iterations
