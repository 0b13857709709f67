"""100 x the batches whose guessed token extent missed (the drain queued
a second copy and waited again) over the batches, from the program's
counters."""

from portbench.spans import ratio


def read(ctx):
    share = ratio(ctx, "refetches", "batches")
    return None if share is None else 100.0 * share
