"""The share of the window's wall time the interpreter spent in garbage
collection (every generation, ``gc.callbacks``), over the part of the
window the profiler does not cover."""


def read(ctx):
    if not ctx.get("rest_s"):
        return None
    return 100.0 * ctx["gc_pause_s"] / ctx["rest_s"]
