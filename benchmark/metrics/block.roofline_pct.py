"""The elementwise ADMM block's share of its byte bound: the bytes one
launch must move (`counts.block_bytes_per_element` of the cell's dtypes
times the elements) over 3.35 TB/s, against the mean device time of the
kernel's records in the traced window. The kernel is found by the name the
profiler gives it (`csrc/elementwise_block.cuh`)."""

from benchmark import counts

BLOCK_KERNEL = "elementwise_block_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    times = [e - s for name, s, e in ctx.trace.kernels() if BLOCK_KERNEL in name]
    if not times:
        return None
    dt = ctx.config["dtype"]
    bound_s = counts.block_bound_s(ctx.config["shape"], counts.block_bytes_per_element(dt, dt, dt, dt))
    return 100.0 * bound_s / (sum(times) / len(times) / 1e6)
