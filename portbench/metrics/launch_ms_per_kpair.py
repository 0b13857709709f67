"""Wall time of the program's `launch` spans (the enqueue of a batch's
kernels and torch ops and of its fetch), summed over the workers, per
thousand pairs."""

from portbench.spans import ms_per_kpair


def read(ctx):
    return ms_per_kpair(ctx, "launch")
