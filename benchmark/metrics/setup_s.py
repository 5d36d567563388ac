"""Set-up: from the start of the process to the end of the warm solve (torch
import, CUDA context, the build or load of the program's kernels, the data
made on the device, one solve of the cell's shapes)."""


def read(ctx):
    return ctx.setup_s
