"""Share of the traced window in which no device record ran: 100 (1 - the
union of the records' intervals / the window), both from one trace."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
