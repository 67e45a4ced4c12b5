"""Share of the traced window in which the card is idle while the host
is inside ``Session.measure`` (the program's ``session.measure`` span),
averaged over the cell's cards."""

from bench import spans


def read(ctx):
    if ctx.trace is None or ctx.entry != "measure":
        return None
    return spans.idle_pct(ctx.trace, ctx.devices, ("session.measure",))
