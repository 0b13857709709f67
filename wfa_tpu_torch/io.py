"""Input parsing and length bucketing.

The pair file format is the WFA-paper benchmarking format used by the
reference CLI (wfa-go.go:166-178): alternating lines, the first character
of each line stripped (conventionally ``>query`` / ``<target``)::

    >ATTGGAAAATAGGATTGG...
    <GATTGGAAAATAGGATGG...

Bucketing groups pairs into shape classes so the jitted device engine
sizes its windows once per class instead of once per file — the analog of the
reference's one-reused-aligner-per-file loop (wfa-go.go:96-111).
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Tuple


def read_pairs(path: str) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (query, target) byte pairs from a WFA-paper format file.

    Mirrors the reference's scanner loop: an unpaired trailing line is
    dropped (wfa-go.go:168-177); the first character of each line is
    stripped unconditionally.
    """
    with open(path, "rb") as fh:
        while True:
            q = fh.readline()
            if not q:
                return
            t = fh.readline()
            if not t:
                return
            yield q.rstrip(b"\r\n")[1:], t.rstrip(b"\r\n")[1:]


def _size_class(n: int) -> int:
    """Round a length up to its bucket size (power-of-two-ish classes)."""
    c = 64
    while c < n:
        c *= 2
    return c


def bucket_pairs(
    indexed_pairs: Iterable[Tuple[int, Tuple[bytes, bytes]]],
) -> Dict[Tuple[int, int], List[Tuple[int, Tuple[bytes, bytes]]]]:
    """Group (index, pair) by padded length class, preserving input order
    within each bucket.  Takes pre-indexed pairs so callers can filter
    (e.g. drop invalid pairs) while keeping original result positions."""
    buckets: Dict[Tuple[int, int], List[Tuple[int, Tuple[bytes, bytes]]]] = {}
    for i, (q, t) in indexed_pairs:
        key = (_size_class(len(q)), _size_class(len(t)))
        buckets.setdefault(key, []).append((i, (q, t)))
    return buckets
