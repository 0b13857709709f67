"""Wall time of the program's `build` spans (the token split and the
result objects), summed over the drain workers, per thousand pairs."""

from portbench.spans import ms_per_kpair


def read(ctx):
    return ms_per_kpair(ctx, "build")
