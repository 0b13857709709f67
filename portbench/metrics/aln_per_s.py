"""Pairs aligned over all the time of the window, from the first call's
start to the last call's end."""

from portbench.stats import rate


def read(ctx):
    if not ctx.get("window_s"):
        return None
    return rate(ctx["pairs"], ctx["window_s"])
