"""Device kernels, copies and sets of the window, on every card, over the
sweeps the window's calls made."""


def read(ctx):
    if ctx.trace is None or ctx.entry != "run" or not ctx.sweeps:
        return None
    return ctx.trace.count() / ctx.sweeps
