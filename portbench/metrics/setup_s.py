"""From the process's start to the first timed call: the interpreter,
the imports, the inputs, the pipeline and its warm-up (and, in a
checkout's first run, the kernels' build)."""


def read(ctx):
    return ctx.get("setup_s")
