"""The program's own records of the window's calls, for the readers of
``portbench/metrics``: ``wfa_tpu_torch.trace`` keeps one record a call of
``align_all`` (wall and CPU ns of each kind of span, the counters); the
calls after the profiled slice are the last ``len(ctx["calls_s"])``.
Each helper returns None where the program keeps no records (a revision
without ``wfa_tpu_torch.trace``) or where those records' pairs do not
add up to the window's."""

from __future__ import annotations

from typing import List, Optional


def records(ctx: dict) -> Optional[List[dict]]:
    """The records of the window's calls after the profiled slice."""
    n = len(ctx.get("calls_s") or ())
    if not n or not ctx.get("pairs"):
        return None
    try:
        from wfa_tpu_torch import trace
    except ImportError:
        return None
    recs = trace.records(n)
    if len(recs) != n or sum(r["pairs"] for r in recs) != ctx["pairs"]:
        return None
    return recs


def _sum(recs: List[dict], kinds, field: str) -> int:
    return sum(r["spans"].get(k, {}).get(field, 0) for r in recs
               for k in kinds)


def ms_per_kpair(ctx: dict, *kinds: str) -> Optional[float]:
    """Wall ms of the spans of ``kinds``, summed over the threads, per
    1000 pairs."""
    recs = records(ctx)
    if recs is None:
        return None
    return _sum(recs, kinds, "wall_ns") / 1e6 / (ctx["pairs"] / 1e3)


def stall_pct(ctx: dict, *kinds: str) -> Optional[float]:
    """100 x (wall - CPU) / wall over the spans of ``kinds``, which read
    their thread's CPU clock."""
    recs = records(ctx)
    if recs is None:
        return None
    wall = _sum(recs, kinds, "wall_ns")
    if not wall:
        return None
    return 100.0 * (wall - _sum(recs, kinds, "cpu_ns")) / wall


def ratio(ctx: dict, num: str, den: str) -> Optional[float]:
    """The counter ``num`` over the counter ``den``, summed over the
    records (None where ``den`` sums to 0)."""
    recs = records(ctx)
    if recs is None:
        return None
    d = sum(r[den] for r in recs)
    if not d:
        return None
    return sum(r[num] for r in recs) / d
