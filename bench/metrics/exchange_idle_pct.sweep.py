"""Share of the traced window in which a card is idle while the host is
inside the sharded tier's halo gather (the program's ``dist.extend``
span), averaged over the cell's cards, for ``Session.run`` traffic.
``None`` where the trace holds no ``dist.extend`` range."""

from bench import spans

GATHER = "dist.extend"


def read(ctx):
    if ctx.trace is None or ctx.entry != "run":
        return None
    if not spans.intervals(ctx.trace, (GATHER,)):
        return None
    return spans.idle_pct(ctx.trace, ctx.devices, (GATHER,))
