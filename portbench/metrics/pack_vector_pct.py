"""100 x the bases the native direct pack put through its vector body
over all the bases it packed, from the program's counters
(`packed_vec_bases`, `packed_bases`); None where the program keeps no
such counters or packed nothing directly."""

from portbench.spans import records


def read(ctx):
    recs = records(ctx)
    if recs is None or any("packed_bases" not in r for r in recs):
        return None
    bases = sum(r["packed_bases"] for r in recs)
    if not bases:
        return None
    return 100.0 * sum(r["packed_vec_bases"] for r in recs) / bases
