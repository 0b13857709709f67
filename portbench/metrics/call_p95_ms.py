"""The 95th percentile, by nearest rank, of every call of the window."""

from portbench.stats import nearest_rank


def read(ctx):
    if not ctx.get("calls_s"):
        return None
    return 1e3 * nearest_rank(ctx["calls_s"], 95)
