"""Launches of the port's kernels (their wrappers' ``launches`` counters)
per thousand pairs, over the part of the window the profiler does not
cover."""


def read(ctx):
    if ctx.get("launches") is None or not ctx.get("pairs"):
        return None
    return ctx["launches"] / (ctx["pairs"] / 1e3)
