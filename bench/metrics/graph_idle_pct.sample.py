"""Share of the traced window in which the card is idle while the host
captures, instantiates or frees the observables' CUDA graph (the
program's ``measure.graph_capture``, ``measure.graph_instantiate`` and
``measure.graph_reset`` spans), averaged over the cell's cards, for
``Session.measure`` traffic."""

from bench import spans

GRAPH = ("measure.graph_capture", "measure.graph_instantiate",
         "measure.graph_reset")


def read(ctx):
    if ctx.trace is None or ctx.entry != "measure":
        return None
    return spans.idle_pct(ctx.trace, ctx.devices, GRAPH)
