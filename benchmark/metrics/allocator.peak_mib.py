"""The allocator's peak of device memory over set-up and window
(`torch.cuda.max_memory_allocated` after a reset at the start), in MiB, in a
cell whose peak follows Python's collector: the program leaves each solve's
loop, its CUDA graph and buffers to the collector, so the peak steps by a
loop as the window's solves pass the collector's thresholds, and the
allocator's growth costs the window `cudaMalloc` calls."""


def read(ctx):
    if ctx.peak_bytes is None:
        return None
    return ctx.peak_bytes / 2**20
