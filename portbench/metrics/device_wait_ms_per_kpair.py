"""Wall time of the program's `wait` spans (the host blocked on the card:
the fetch's events, `.cpu()` copies), summed over the threads, per
thousand pairs."""

from portbench.spans import ms_per_kpair


def read(ctx):
    return ms_per_kpair(ctx, "wait")
