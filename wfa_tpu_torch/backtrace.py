"""Backtrace: CIGAR reconstruction from M/I/D component state.

These functions are storage-agnostic: they operate on any objects exposing
the small component protocol (``get``, ``get_raw``, ``get_after_diff``,
``has_score``, ``k_range``), which the oracle's dict-backed components
satisfy.  The algorithm is the reference's backtrace (wfa.go:703-983) and
semi-global end finder (wfa.go:270-375), transcribed exactly; the port's
own copy of :mod:`wfa_tpu.backtrace`, which the oracle needs.  The device
path chases its aux tensor instead (kernel K2, :mod:`.device_backtrace`).
"""

from __future__ import annotations

from typing import Tuple

from .cigar import AlignmentResult
from .constants import (
    OPS,
    T_DEL_EXT,
    T_DEL_OPEN,
    T_INS_EXT,
    T_INS_OPEN,
    T_MATCH,
    T_MISMATCH,
    TYPE_BITS,
    TYPE_MASK,
    Penalties,
)


def backtrace_start_position(M, len_q: int, len_t: int, s: int) -> Tuple[int, int]:
    """Semi-global end finder: minimum score on the last row/column
    (wfa.go:270-375), with its exact scan-break behavior."""
    m, n = len_t, len_q
    min_s = s
    Ak = m - n
    last_k = Ak

    for _s in range(s, -1, -1):
        if not M.has_score(_s):
            continue
        lo, hi = M.k_range(_s, 0)

        # scan k downward from Ak (wfa.go:298-331)
        last_row_or_col = False
        k = Ak
        while True:
            if k < lo:
                break
            offset, _, ok = M.get_after_diff(_s, 0, k)
            if not ok:
                k -= 1
                continue
            h = offset
            v = h - k
            if v <= 0 or v > n or h > m:  # bound check
                break
            if (v == n and h >= n) or (h == m and v >= m):
                last_row_or_col = True
                break
            k -= 1
        if last_row_or_col and _s <= min_s:
            last_k = k
            min_s = _s

        # scan k upward from Ak+1 (wfa.go:333-366)
        last_row_or_col = False
        k = Ak + 1
        while True:
            if k > hi:
                break
            offset, _, ok = M.get_after_diff(_s, 0, k)
            if not ok:
                k += 1
                continue
            h = offset
            v = h - k
            if v <= 0 or v > n or h > m:
                break
            if (v == n and h >= n) or (h == m and v >= m):
                last_row_or_col = True
                break
            k += 1
        if last_row_or_col and _s <= min_s:
            last_k = k
            min_s = _s

    return min_s, last_k


def back_trace(
    M,
    I,
    D,
    p: Penalties,
    global_alignment: bool,
    q: bytes,
    t: bytes,
    s: int,
    Ak: int,
) -> AlignmentResult:
    """Rebuild the CIGAR from (s, k) — exact port of wfa.go:703-983.

    Ops are emitted end-to-front; :meth:`AlignmentResult.process` reverses
    and merges them.  Pre-extension offsets are recomputed by re-running
    next()'s max rule (without its bound checks — faithful to the
    reference, wfa.go:757-827).
    """
    semi_global = not global_alignment
    len_q = len(q)
    len_t = len(t)

    cigar = AlignmentResult(global_alignment)
    cigar.score = s

    k = Ak
    first_match = True
    q_begin = t_begin = 0
    from_itself = False

    # start point (wfa.go:738-750); existence deliberately unchecked.
    offset, _ = M.get_raw(s, k)
    previous_from_m = True
    tag = offset & TYPE_MASK
    h = offset >> TYPE_BITS
    v = h - k

    if h < len_t:
        cigar.add_n(OPS[T_INS_OPEN], len_t - h)
    elif v < len_q:
        cigar.add_n("H", len_q - v)

    while v > 0 and h > 0:
        s_mismatch = s - p.mismatch
        s_gap_open = s - p.gap_open - p.gap_ext
        s_gap_ext = s - p.gap_ext

        if tag == T_INS_EXT:
            v1, _, from_m = M.get(s_gap_open, k - 1)
            v2, _, from_i = I.get(s_gap_ext, k - 1)
            offset0 = max(v1, v2) + 1 if (from_m or from_i) else 0
            M0 = I
        elif tag == T_DEL_EXT:
            v1, _, from_m = M.get(s_gap_open, k + 1)
            v2, _, from_d = D.get(s_gap_ext, k + 1)
            offset0 = max(v1, v2) if (from_m or from_d) else 0
            M0 = D
        else:
            v1, _, from_m = M.get(s_gap_open, k - 1)
            v2, _, from_i = I.get(s_gap_ext, k - 1)
            from_mi = from_m or from_i
            Isk = max(v1, v2) + 1 if from_mi else 0

            v1, _, from_m = M.get(s_gap_open, k + 1)
            v2, _, from_d = D.get(s_gap_ext, k + 1)
            from_md = from_m or from_d
            Dsk = max(v1, v2) if from_md else 0

            v1, _, from_m = M.get(s_mismatch, k)
            if from_mi or from_md or from_m:
                offset0 = max(Isk, Dsk, v1 + 1)
                from_itself = False
            else:
                from_itself = True
                offset0 = 0
            M0 = M
        if from_itself:
            break
        if offset0 == 0:
            break

        h0 = offset0

        # traceback matches (wfa.go:832-869)
        if previous_from_m:
            n_matches = h - h0
            if n_matches > 0:
                if first_match:
                    first_match = False
                    cigar.t_end, cigar.q_end = h, v
                cigar.add_n(OPS[T_MATCH], n_matches)

            offset = offset0
            h = offset
            v = h - k

            if tag == T_MATCH:  # first line/row
                t_begin, q_begin = h, v
            elif n_matches > 0:
                t_begin, q_begin = h + 1, v + 1

            if h <= 0 or v <= 0:
                break

        # record (wfa.go:871-874)
        cigar.add_n(OPS[tag], 1)

        if semi_global and (h == 1 or v == 1):
            break

        # step to the source cell (wfa.go:884-909)
        previous_from_m = True
        if tag == T_MISMATCH:
            s = s_mismatch
            h -= 1
        elif tag == T_INS_OPEN:
            s = s_gap_open
            k -= 1
            h -= 1
        elif tag == T_INS_EXT:
            s = s_gap_ext
            k -= 1
            h -= 1
            previous_from_m = False
        elif tag == T_DEL_OPEN:
            s = s_gap_open
            k += 1
        elif tag == T_DEL_EXT:
            s = s_gap_ext
            k += 1
            previous_from_m = False
        else:  # invalid/Match tag mid-path
            break
        v = h - k

        offset, ok = M0.get_raw(s, k)
        if not ok:
            break
        tag = offset & TYPE_MASK

    # the last one (wfa.go:930-968)
    if h > 0 and v > 0:
        n_matches = min(h, v) - 1
        if n_matches > 0:
            if first_match:
                first_match = False
                cigar.t_end, cigar.q_end = h, v
            cigar.add_n(OPS[T_MATCH], n_matches)
            h -= n_matches
            v -= n_matches
            if tag == T_MATCH:
                t_begin, q_begin = h, v
            else:
                t_begin, q_begin = h + 1, v + 1
        elif tag == T_MATCH:
            t_begin, q_begin = h, v
            if first_match:
                first_match = False
                cigar.t_end, cigar.q_end = h, v
        cigar.add_n(OPS[tag], 1)

    if v > 1:
        cigar.add_n("H", v - 1)
    if h > 1:
        cigar.add_n(OPS[T_INS_OPEN], h - 1)

    cigar.t_begin, cigar.q_begin = t_begin, q_begin
    cigar.process()
    return cigar
