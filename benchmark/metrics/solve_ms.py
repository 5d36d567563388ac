"""Wall time a solve, over the window: the sum of every completed solve's
time (host clock, from the call to the synchronize after it) over their
count, so a stall in the window counts."""


def read(ctx):
    if not ctx.solve_s:
        return None
    return 1e3 * sum(ctx.solve_s) / len(ctx.solve_s)
