"""Wall time of the program's `upload` spans (every host-to-card copy of
a batch's rows), summed over the submit workers, per thousand pairs."""

from portbench.spans import ms_per_kpair


def read(ctx):
    return ms_per_kpair(ctx, "upload")
