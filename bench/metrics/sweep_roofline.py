"""The least time the cell's cards need for the window's attempted flips
(``bench/roofline.py``, the configuration's family) over the device
time of the sweep kernels, averaged over the cards, in %."""

from bench import roofline


def read(ctx):
    if ctx.trace is None or ctx.entry != "run":
        return None
    kernels = sum(ctx.trace.op_seconds(d, sweep=True)
                  for d in ctx.devices) / len(ctx.devices)
    if kernels <= 0:
        return None
    counts = roofline.family(ctx.cell.config["family"])
    least = roofline.least_seconds(counts, ctx.flips,
                                   ctx.cell.geometry.state_bytes(),
                                   ctx.calls, ctx.chips)
    return 100.0 * least / kernels
