"""Share of the traced window in which no kernel, copy or set ran on the
card, averaged over the cell's cards, for ``Session.run`` traffic."""


def read(ctx):
    if ctx.trace is None or ctx.entry != "run":
        return None
    return 100.0 * (1.0 - ctx.trace.mean_busy_s() / ctx.trace.window_s)
