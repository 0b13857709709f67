"""The mean over the mesh's steps of the last `shard` span's end less the
first's: how long the one submit worker takes to reach the last card
after the first, from the program's spans."""

from portbench.spans import ratio


def read(ctx):
    lag = ratio(ctx, "shard_lag_ns", "shard_steps")
    return None if lag is None else lag / 1e6
