"""The port's score-loop, prefix, resume and backtrace launches in the
profiled slice: the least time an H100 needs for them
(``portbench.roofline``) over their own device time in the trace."""


def read(ctx):
    roof = ctx.get("roofline")
    if roof is None or not ctx.get("kernel_s"):
        return None
    return 100.0 * roof[0] / ctx["kernel_s"]
