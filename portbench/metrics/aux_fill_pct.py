"""100 x the aux rows the served pairs used (final_s + 1 each) over the
aux rows the launched batches allocated (the score cap times their
pairs), from the program's counters (``aux_rows_used``, ``aux_rows``);
None where the program keeps no such counters or launched nothing."""

from portbench.spans import records


def read(ctx):
    recs = records(ctx)
    if recs is None or any("aux_rows" not in r for r in recs):
        return None
    rows = sum(r["aux_rows"] for r in recs)
    if not rows:
        return None
    return 100.0 * sum(r["aux_rows_used"] for r in recs) / rows
