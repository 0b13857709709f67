"""Thread time in ``BatchAligner.submit_batch`` (pack, upload, launches),
summed over the submit workers, per thousand pairs."""


def read(ctx):
    t = ctx.get("thread_s", {}).get("submit")
    if t is None or not ctx.get("pairs"):
        return None
    return 1e3 * t / (ctx["pairs"] / 1e3)
