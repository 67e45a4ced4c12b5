"""The largest ``torch.cuda.max_memory_allocated`` over the cell's
cards, from the process's start to the window's close, in GiB."""


def read(ctx):
    if not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 2 ** 30
