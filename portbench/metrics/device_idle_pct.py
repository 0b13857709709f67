"""100 less the share of the profiled slice's wall in which a kernel, a
copy or a set ran on the card (the union of their intervals), averaged
over the cards the cell uses."""


def read(ctx):
    if not ctx.get("slice_s") or ctx.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["slice_s"])
