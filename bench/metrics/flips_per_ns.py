"""Attempted (replica-)flips of the window's ``Session.run`` calls over
the window's nanoseconds, the window closing once every card is
synchronized."""


def read(ctx):
    if ctx.entry != "run":
        return None
    return ctx.flips / (ctx.window_s * 1e9)
