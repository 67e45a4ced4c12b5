"""Samples of the window's ``Session.measure`` calls, all of them on the
host, over the window's seconds."""


def read(ctx):
    if ctx.entry != "measure":
        return None
    return ctx.samples / ctx.window_s
