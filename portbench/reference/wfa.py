"""A frozen gap-affine wavefront aligner: the answer every pair must get.

A scalar transcription of the reference aligner's semantics (the Go
package shenwei356/wfa, v0.4.0): seeding (wfa.go:143-184), extend
(wfa.go:381-458), wf-adaptive reduction (wfa.go:461-540), next with its
tie-breaks (wfa.go:549-700), the semi-global end finder (wfa.go:270-375),
the backtrace (wfa.go:703-983) and the CIGAR's stats (wfa_cigar.go:136-214).
Wavefronts are dicts of ``offset << 3 | tag`` cells, 0 for absent.

``Aligner(..., gap_first=True)`` breaks one guarantee on purpose: where
a gap ties a mismatch for a cell it takes the gap.  The scores stay
optimal and the CIGARs change (on about half of the pairs of 1,000 bases
at 5% error), which is the shortcut a faster score loop or backtrace
might take; the benchmark's control runs it in the program's place and
must come out not correct.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

TYPE_BITS = 3
TYPE_MASK = 7
T_INS_OPEN, T_INS_EXT, T_DEL_OPEN, T_DEL_EXT, T_MISMATCH, T_MATCH = range(1, 7)
# tag -> CIGAR op; 'I' consumes the target, 'D' and 'H' the query
OPS = (".", "I", "I", "D", "D", "X", "M", "H")
_BIG = 1 << 60


class _WaveFront:
    __slots__ = ("lo", "hi", "cells")

    def __init__(self) -> None:
        self.lo = _BIG
        self.hi = -_BIG
        self.cells: Dict[int, int] = {}

    def set(self, k: int, packed: int) -> None:
        self.cells[k] = packed
        if k < self.lo:
            self.lo = k
        if k > self.hi:
            self.hi = k

    def get(self, k: int) -> Tuple[int, int, bool]:
        if k < self.lo or k > self.hi:
            return 0, 0, False
        cell = self.cells.get(k, 0)
        return cell >> TYPE_BITS, cell & TYPE_MASK, cell > 0

    def get_raw(self, k: int) -> Tuple[int, bool]:
        if k < self.lo or k > self.hi:
            return 0, False
        cell = self.cells.get(k, 0)
        return cell, cell > 0

    def delete(self, k: int) -> None:
        # shrinks the band only at its edges, hi tested first
        if k < self.lo or k > self.hi:
            return
        self.cells[k] = 0
        if k == self.hi:
            self.hi -= 1
        elif k == self.lo:
            self.lo += 1


class _Component:
    __slots__ = ("wavefronts",)

    def __init__(self) -> None:
        self.wavefronts: Dict[int, _WaveFront] = {}

    def has_score(self, s: int) -> bool:
        return s in self.wavefronts

    def k_range(self, s: int, diff: int) -> Tuple[int, int]:
        # (0, 0) for an absent score feeds next()'s band: kept as is
        if diff > s:
            return 0, 0
        wf = self.wavefronts.get(s - diff)
        if wf is None:
            return 0, 0
        return wf.lo, wf.hi

    def set(self, s: int, k: int, offset: int, tag: int) -> None:
        wf = self.wavefronts.get(s)
        if wf is None:
            wf = self.wavefronts[s] = _WaveFront()
        wf.set(k, (offset << TYPE_BITS) | tag)

    def get(self, s: int, k: int) -> Tuple[int, int, bool]:
        wf = self.wavefronts.get(s) if s >= 0 else None
        if wf is None:
            return 0, 0, False
        return wf.get(k)

    def get_raw(self, s: int, k: int) -> Tuple[int, bool]:
        wf = self.wavefronts.get(s) if s >= 0 else None
        if wf is None:
            return 0, False
        return wf.get_raw(k)

    def get_after_diff(self, s: int, diff: int, k: int):
        if diff > s:
            return 0, 0, False
        return self.get(s - diff, k)

    def delete(self, s: int, k: int) -> None:
        wf = self.wavefronts.get(s)
        if wf is not None:
            wf.delete(k)


class Result:
    """Score, CIGAR runs, 1-based matched-region coordinates and stats."""

    __slots__ = ("score", "ops", "q_begin", "q_end", "t_begin", "t_end",
                 "align_len", "matches", "gaps", "gap_regions")

    def __init__(self) -> None:
        self.score = 0
        self.ops: List[Tuple[str, int]] = []
        self.q_begin = self.q_end = self.t_begin = self.t_end = 0
        self.align_len = self.matches = self.gaps = self.gap_regions = 0

    def process(self) -> None:
        """Reverse the end-to-front runs, merge them, and count the stats
        between the first and the last M run (wfa_cigar.go:136-214)."""
        merged: List[Tuple[str, int]] = []
        for op, n in reversed(self.ops):
            if merged and merged[-1][0] == op:
                merged[-1] = (op, merged[-1][1] + n)
            else:
                merged.append((op, n))
        self.ops = merged
        ms = [i for i, (op, _) in enumerate(merged) if op == "M"]
        begin, end = (ms[0], ms[-1]) if ms else (0, 0)
        for op, n in merged[begin:end + 1]:
            self.align_len += n
            if op == "M":
                self.matches += n
            elif op in ("I", "D"):
                self.gaps += n
                self.gap_regions += 1


def answer(res) -> tuple:
    """What is compared of a result, the program's or the reference's:
    score, CIGAR runs, coordinates and stats."""
    return (res.score, tuple((op, int(n)) for op, n in res.ops),
            res.q_begin, res.q_end, res.t_begin, res.t_end,
            res.align_len, res.matches, res.gaps, res.gap_regions)


class Aligner:
    """``penalties`` (mismatch, gap open, gap extension); ``adaptive``
    (min_wf_len, max_dist_diff) or None for none."""

    def __init__(self, penalties=(4, 6, 2), global_alignment: bool = True,
                 adaptive: Optional[Tuple[int, int]] = (10, 50),
                 gap_first: bool = False) -> None:
        self.x, self.o, self.e = penalties
        self.global_alignment = global_alignment
        if adaptive is not None and adaptive[0] == 0:
            raise ValueError("min_wf_len must not be 0")
        self.adaptive = adaptive
        self.gap_first = gap_first

    def align(self, q: bytes, t: bytes) -> Result:
        if not q or not t:
            raise ValueError("empty sequence")
        n, m = len(q), len(t)
        qa = np.frombuffer(q, np.uint8)
        ta = np.frombuffer(t, np.uint8)
        self.M, self.I, self.D = _Component(), _Component(), _Component()
        self._seed(q, t)
        Ak = m - n
        s = 0
        while True:
            if self.M.has_score(s):
                lo, hi = self._extend(qa, ta, s)
                offset, _, _ = self.M.get_after_diff(s, 0, Ak)
                if offset >= m:
                    break
                if self.adaptive is not None and \
                        hi - lo + 1 >= self.adaptive[0]:
                    self._reduce(qa, ta, s)
            s += 1
            self._next(n, m, s)
        last_k = Ak
        if not self.global_alignment:
            s, last_k = _end_position(self.M, n, m, s)
        return self._back_trace(q, t, s, last_k)

    def _seed(self, q: bytes, t: bytes) -> None:
        M, x = self.M, self.x

        def cell(a, b):
            return (T_MATCH, 0) if a == b else (T_MISMATCH, x)

        tag, score = cell(q[0], t[0])
        M.set(score, 0, 1, tag)
        if not self.global_alignment:
            for k in range(1, len(t)):  # the first row
                tag, score = cell(q[0], t[k])
                M.set(score, k, k + 1, tag)
            for k in range(1, len(q)):  # the first column
                tag, score = cell(q[k], t[0])
                M.set(score, -k, 1, tag)

    def _extend(self, qa, ta, s: int) -> Tuple[int, int]:
        wf = self.M.wavefronts[s]
        lo, hi = wf.lo, wf.hi
        nq, nt = len(qa), len(ta)
        for k in range(hi, lo - 1, -1):
            packed, ok = wf.get_raw(k)
            if not ok:
                continue
            h = packed >> TYPE_BITS
            v = h - k
            if v <= 0 or v >= nq or h >= nt:
                continue
            lim = min(nq - v, nt - h)
            eq = qa[v:v + lim] == ta[h:h + lim]
            run = int(lim if eq.all() else np.argmin(eq))
            if run:
                wf.cells[k] = packed + (run << TYPE_BITS)
        return lo, hi

    def _reduce(self, qa, ta, s: int) -> None:
        wf = self.M.wavefronts[s]
        lo, hi = wf.lo, wf.hi
        nq, nt = len(qa), len(ta)
        ds = []
        min_dist = _BIG
        for k in range(lo, hi + 1):
            h, _, ok = wf.get(k)
            v = h - k
            if not ok or v < 0 or v >= nq or h >= nt:
                ds.append(-1)
                continue
            d = max(nt - h, nq - v)
            ds.append(d)
            min_dist = min(min_dist, d)
        new_lo, new_hi = lo, hi
        update_lo, found = True, False
        for i, d in enumerate(ds):
            if d < 0:
                continue
            if d - min_dist > self.adaptive[1]:
                found = True
                if update_lo:
                    new_lo = lo + i + 1
                ds[i] = -1
            else:
                update_lo = False
        if found:
            for i in range(len(ds) - 1, -1, -1):
                if ds[i] >= 0:
                    new_hi = lo + i
                    break
        for k in (*range(lo, new_lo), *range(new_hi + 1, hi + 1)):
            wf.delete(k)
            self.I.delete(s, k)
            self.D.delete(s, k)
        wf.lo, wf.hi = new_lo, new_hi

    def _next(self, nq: int, nt: int, s: int) -> None:
        M, I, D = self.M, self.I, self.D
        x, oe, e = self.x, self.o + self.e, self.e
        bands = (M.k_range(s, x), M.k_range(s, oe), I.k_range(s, e),
                 D.k_range(s, e))
        hi = min(nt - 1, max(b[1] for b in bands) + 1)
        lo = max(-(nq - 1), min(b[0] for b in bands) - 1)
        for k in range(lo, hi + 1):
            v1, _, from_m = M.get_after_diff(s, oe, k - 1)
            v2, _, from_i = I.get_after_diff(s, e, k - 1)
            if from_m and v1 > nt:
                from_m, v1 = False, 0
            if from_i and v2 > nt:
                from_i, v2 = False, 0
            Isk = max(v1, v2) + 1
            updated_i = from_m or from_i
            tag_i = 0
            if updated_i:
                tag_i = (T_INS_OPEN if not from_i or (from_m and v1 >= v2)
                         else T_INS_EXT)
                I.set(s, k, Isk, tag_i)
            else:
                Isk = 0

            v1, _, from_m = M.get_after_diff(s, oe, k + 1)
            v2, _, from_d = D.get_after_diff(s, e, k + 1)
            if from_m and v1 - k > nq:
                from_m, v1 = False, 0
            if from_d and v2 - k > nq:
                from_d, v2 = False, 0
            Dsk = max(v1, v2)
            updated_d = from_m or from_d
            tag_d = 0
            if updated_d:
                tag_d = (T_DEL_OPEN if not from_d or (from_m and v1 >= v2)
                         else T_DEL_EXT)
                D.set(s, k, Dsk, tag_d)
            else:
                Dsk = 0

            v1, _, from_m = M.get_after_diff(s, x, k)
            if from_m and (v1 > nt or v1 - k > nq):
                from_m, v1 = False, 0
            Msk = max(Isk, Dsk, v1 + 1)
            if updated_i or updated_d or from_m:
                # ties: mismatch first, then insertion, then deletion
                gap = ((updated_i and Msk == Isk)
                       or (updated_d and Msk == Dsk))
                if from_m and Msk == v1 + 1 and not (self.gap_first
                                                      and gap):
                    tag_m = T_MISMATCH
                elif updated_i and Msk == Isk:
                    tag_m = tag_i
                else:
                    tag_m = tag_d
                M.set(s, k, Msk, tag_m)

    def _back_trace(self, q: bytes, t: bytes, s: int, Ak: int) -> Result:
        """wfa.go:703-983: ops end to front, pre-extension offsets
        recomputed by next()'s max rule without its bound checks."""
        M, I, D = self.M, self.I, self.D
        x, o, e = self.x, self.o, self.e
        semi = not self.global_alignment
        nq, nt = len(q), len(t)
        res = Result()
        res.score = s
        add = res.ops.append
        k = Ak
        first_match = True
        q_begin = t_begin = 0
        from_itself = False
        packed, _ = M.get_raw(s, k)
        previous_from_m = True
        tag = packed & TYPE_MASK
        h = packed >> TYPE_BITS
        v = h - k
        if h < nt:
            add((OPS[T_INS_OPEN], nt - h))
        elif v < nq:
            add(("H", nq - v))

        while v > 0 and h > 0:
            s_x, s_o, s_e = s - x, s - o - e, s - e
            if tag == T_INS_EXT:
                v1, _, from_m = M.get(s_o, k - 1)
                v2, _, from_i = I.get(s_e, k - 1)
                offset0 = max(v1, v2) + 1 if (from_m or from_i) else 0
                M0 = I
            elif tag == T_DEL_EXT:
                v1, _, from_m = M.get(s_o, k + 1)
                v2, _, from_d = D.get(s_e, k + 1)
                offset0 = max(v1, v2) if (from_m or from_d) else 0
                M0 = D
            else:
                v1, _, from_m = M.get(s_o, k - 1)
                v2, _, from_i = I.get(s_e, k - 1)
                from_mi = from_m or from_i
                Isk = max(v1, v2) + 1 if from_mi else 0
                v1, _, from_m = M.get(s_o, k + 1)
                v2, _, from_d = D.get(s_e, k + 1)
                from_md = from_m or from_d
                Dsk = max(v1, v2) if from_md else 0
                v1, _, from_m = M.get(s_x, k)
                from_itself = not (from_mi or from_md or from_m)
                offset0 = 0 if from_itself else max(Isk, Dsk, v1 + 1)
                M0 = M
            if from_itself or offset0 == 0:
                break
            if previous_from_m:
                n_matches = h - offset0
                if n_matches > 0:
                    if first_match:
                        first_match = False
                        res.t_end, res.q_end = h, v
                    add(("M", n_matches))
                h = offset0
                v = h - k
                if tag == T_MATCH:
                    t_begin, q_begin = h, v
                elif n_matches > 0:
                    t_begin, q_begin = h + 1, v + 1
                if h <= 0 or v <= 0:
                    break
            add((OPS[tag], 1))
            if semi and (h == 1 or v == 1):
                break
            previous_from_m = True
            if tag == T_MISMATCH:
                s = s_x
                h -= 1
            elif tag == T_INS_OPEN:
                s, k, h = s_o, k - 1, h - 1
            elif tag == T_INS_EXT:
                s, k, h = s_e, k - 1, h - 1
                previous_from_m = False
            elif tag == T_DEL_OPEN:
                s, k = s_o, k + 1
            elif tag == T_DEL_EXT:
                s, k = s_e, k + 1
                previous_from_m = False
            else:
                break
            v = h - k
            packed, ok = M0.get_raw(s, k)
            if not ok:
                break
            tag = packed & TYPE_MASK

        if h > 0 and v > 0:
            n_matches = min(h, v) - 1
            if n_matches > 0:
                if first_match:
                    first_match = False
                    res.t_end, res.q_end = h, v
                add(("M", n_matches))
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
                    res.t_end, res.q_end = h, v
            add((OPS[tag], 1))
        if v > 1:
            add(("H", v - 1))
        if h > 1:
            add((OPS[T_INS_OPEN], h - 1))
        res.t_begin, res.q_begin = t_begin, q_begin
        res.process()
        return res


def _end_position(M: _Component, nq: int, nt: int, s: int):
    """The semi-global end finder (wfa.go:270-375): the least score at
    which a cell reaches the last row or column, with the scan's breaks."""
    Ak = nt - nq
    min_s, last_k = s, Ak
    for _s in range(s, -1, -1):
        if not M.has_score(_s):
            continue
        lo, hi = M.k_range(_s, 0)
        for k, step, stop in ((Ak, -1, lo), (Ak + 1, 1, hi)):
            reached = False
            while (k >= stop) if step < 0 else (k <= stop):
                h, _, ok = M.get(_s, k)
                if not ok:
                    k += step
                    continue
                v = h - k
                if v <= 0 or v > nq or h > nt:
                    break
                if (v == nq and h >= nq) or (h == nt and v >= nt):
                    reached = True
                    break
                k += step
            if reached and _s <= min_s:
                last_k, min_s = k, _s
    return min_s, last_k
