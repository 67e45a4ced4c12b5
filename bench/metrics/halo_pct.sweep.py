"""Share of the cards' device time spent in operations other than the
shard kernel (kernels named ``multispin_sweeps_kernel``): the halo
gather's copies, and any other kernel, copy or set, averaged over the
cell's cards, for ``Session.run`` traffic.  ``None`` where the trace
holds no such kernel."""

SHARD_KERNEL = "multispin_sweeps_kernel"


def read(ctx):
    if ctx.trace is None or ctx.entry != "run":
        return None
    shares = []
    for d in ctx.devices:
        ops = ctx.trace.ops.get(d, [])
        total = sum(op.end - op.start for op in ops)
        kernel = sum(op.end - op.start for op in ops
                     if SHARD_KERNEL in op.name)
        if kernel <= 0:
            return None
        shares.append(100.0 * (total - kernel) / total)
    return sum(shares) / len(shares) if shares else None
