"""Share of the traced window in which the card is idle while the host
is inside ``Session.run`` (the program's ``session.run`` span), averaged
over the cell's cards."""

from bench import spans


def read(ctx):
    if ctx.trace is None or ctx.entry != "run":
        return None
    return spans.idle_pct(ctx.trace, ctx.devices, ("session.run",))
