"""The allocator's peak of device memory over set-up and window
(`torch.cuda.max_memory_allocated` after a reset at the start), in MiB."""


def read(ctx):
    if ctx.peak_bytes is None:
        return None
    return ctx.peak_bytes / 2**20
