"""Wall time of the program's `gate` spans (the caller blocked at the cap
on batches in flight or the byte gate) and `queue` spans (a batch handed
to the submit pool until a worker takes it), per thousand pairs."""

from portbench.spans import ms_per_kpair


def read(ctx):
    return ms_per_kpair(ctx, "gate", "queue")
