"""Thread time in ``BatchAligner.finish_small`` and ``finish_tokens``
(fetch, token split, result objects), summed over the drain workers, per
thousand pairs."""


def read(ctx):
    t = ctx.get("thread_s", {}).get("finish")
    if t is None or not ctx.get("pairs"):
        return None
    return 1e3 * t / (ctx["pairs"] / 1e3)
