"""Wall time of the program's `pack` spans (the batch's rows packed on
the host: `_pack_all`, `_seq_lens`, the two-phase re-placement), summed
over the submit workers, per thousand pairs."""

from portbench.spans import ms_per_kpair


def read(ctx):
    return ms_per_kpair(ctx, "pack")
