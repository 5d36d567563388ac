"""The SVT's share of its flop bound: the Golub-Kahan flops of the
iteration's TT unfoldings (`counts.tt_unfoldings`, `counts.svd_bound_s`)
over 67 TFLOP/s, against the device's busy time an iteration (the union of
every record in the traced window over the iterations). The work counted
depends on the shapes alone and the time is all the device's, so the share
reads the same work whatever implements the SVD, and no kernel name is
needed."""

from benchmark import counts


def read(ctx):
    if ctx.trace is None:
        return None
    bound_s = sum(counts.svd_bound_s(m, n) for m, n in counts.tt_unfoldings(ctx.config["shape"]))
    return 100.0 * bound_s / (ctx.trace.busy_s / ctx.trace.iterations)
