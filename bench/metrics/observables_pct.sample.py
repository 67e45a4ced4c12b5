"""Share of the window's device time not spent in sweep kernels, for
``Session.measure`` traffic: the observables, their graph and copies."""


def read(ctx):
    if ctx.trace is None or ctx.entry != "measure":
        return None
    total = sum(ctx.trace.op_seconds(d) for d in ctx.devices)
    if total <= 0:
        return None
    other = sum(ctx.trace.op_seconds(d, sweep=False) for d in ctx.devices)
    return 100.0 * other / total
