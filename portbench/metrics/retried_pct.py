"""100 x the pairs that a tier above 0 of the tier ladder ran over the
pairs, from the program's counters (``retried_pairs``, ``pairs``); None
where the program keeps no such counter."""

from portbench.spans import records


def read(ctx):
    recs = records(ctx)
    if recs is None or any("retried_pairs" not in r for r in recs):
        return None
    return 100.0 * sum(r["retried_pairs"] for r in recs) / ctx["pairs"]
