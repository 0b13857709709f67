"""Executable specification of the WFA engine (pure Python/NumPy).

This module is the *oracle*: a direct, scalar transcription of the exact
semantics of the reference gap-affine wavefront aligner — seeding
(wfa.go:143-184), extend (wfa.go:381-458), next with its tie-breaking rules
(wfa.go:549-700), wf-adaptive reduction (wfa.go:461-540), the semi-global
end finder (wfa.go:270-375) and the backtrace (wfa.go:703-983).  The
port's engine (wfa_tpu_torch.engine) must agree with this module
bit-for-bit on scores, CIGARs, coordinates and stats; the test-suite
enforces that.  The port's own copy of :mod:`wfa_tpu.oracle`.

It is intentionally simple and unoptimized — correctness reference only.
The storage layout here (per-score dict wavefronts) is *not* the device
layout; only the observable semantics match.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .backtrace import back_trace, backtrace_start_position
from .cigar import AlignmentResult
from .constants import (
    MAX_SEQ_LEN,
    T_DEL_EXT,
    T_DEL_OPEN,
    T_INS_EXT,
    T_INS_OPEN,
    T_MATCH,
    T_MISMATCH,
    TYPE_BITS,
    TYPE_MASK,
    AdaptiveReductionOption,
    EmptySeqError,
    Options,
    Penalties,
    SeqTooLongError,
)

_BIG = 1 << 60


class WaveFront:
    """Offsets for all diagonals k at one score (wfa_wavefront.go:45-48).

    Cells are ``offset << 3 | tag``; a value of 0 means absent.  ``lo``/
    ``hi`` track the live diagonal band.  The reference's interleaved
    index layout (wfa_wavefront.go:77-82) is an append-friendliness hack
    that is not observable; a dict is used here instead.
    """

    __slots__ = ("lo", "hi", "cells")

    def __init__(self) -> None:
        self.lo = _BIG
        self.hi = -_BIG
        self.cells: Dict[int, int] = {}

    def set(self, k: int, offset: int, tag: int) -> None:
        """wfa_wavefront.go:85-104"""
        self.cells[k] = (offset << TYPE_BITS) | tag
        if k < self.lo:
            self.lo = k
        if k > self.hi:
            self.hi = k

    def set_raw(self, k: int, packed: int) -> None:
        """wfa_wavefront.go:108-127"""
        self.cells[k] = packed
        if k < self.lo:
            self.lo = k
        if k > self.hi:
            self.hi = k

    def increase(self, k: int, delta: int) -> None:
        """Adds delta<<3, preserving the tag (wfa_wavefront.go:131-150)."""
        self.cells[k] = self.cells.get(k, 0) + (delta << TYPE_BITS)
        if k < self.lo:
            self.lo = k
        if k > self.hi:
            self.hi = k

    def get(self, k: int) -> Tuple[int, int, bool]:
        """Returns (offset, tag, existed) (wfa_wavefront.go:153-159)."""
        if k < self.lo or k > self.hi:
            return 0, 0, False
        cell = self.cells.get(k, 0)
        return cell >> TYPE_BITS, cell & TYPE_MASK, cell > 0

    def get_raw(self, k: int) -> Tuple[int, bool]:
        """wfa_wavefront.go:162-168"""
        if k < self.lo or k > self.hi:
            return 0, False
        cell = self.cells.get(k, 0)
        return cell, cell > 0

    def delete(self, k: int) -> None:
        """Zero a cell; shrink the band only at its edges
        (wfa_wavefront.go:171-183; note: hi is checked first)."""
        if k < self.lo or k > self.hi:
            return
        self.cells[k] = 0
        if k == self.hi:
            self.hi -= 1
        elif k == self.lo:
            self.lo += 1

    def __str__(self) -> str:
        """List all offsets (wfa_wavefront.go:186-198)."""
        from .constants import type2str

        parts = [f"k range: [{self.lo}, {self.hi}]."]
        for k in range(self.lo, self.hi + 1):
            offset, tag, ok = self.get(k)
            if ok:
                parts.append(f" k({k}):{offset}({type2str(tag)})")
        return "".join(parts)


class Component:
    """Score-indexed collection of wavefronts (wfa_component.go:37-41)."""

    __slots__ = ("is_m", "wavefronts")

    def __init__(self, is_m: bool = False) -> None:
        self.is_m = is_m
        self.wavefronts: Dict[int, WaveFront] = {}

    def reset(self) -> None:
        self.wavefronts.clear()

    def has_score(self, s: int) -> bool:
        return s in self.wavefronts

    def k_range(self, s: int, diff: int) -> Tuple[int, int]:
        """Band of score s-diff, (0,0) when invalid (wfa_component.go:91-101).

        NOTE: the (0,0) fallback for absent scores is observable — it feeds
        the band bounds of ``next`` — and must be preserved.
        """
        if diff > s:
            return 0, 0
        wf = self.wavefronts.get(s - diff)
        if wf is None:
            return 0, 0
        return wf.lo, wf.hi

    def _wf(self, s: int) -> WaveFront:
        wf = self.wavefronts.get(s)
        if wf is None:
            wf = WaveFront()
            self.wavefronts[s] = wf
        return wf

    def set(self, s: int, k: int, offset: int, tag: int) -> None:
        self._wf(s).set(k, offset, tag)

    def set_raw(self, s: int, k: int, packed: int) -> None:
        self._wf(s).set_raw(k, packed)

    def get(self, s: int, k: int) -> Tuple[int, int, bool]:
        if s < 0:
            return 0, 0, False
        wf = self.wavefronts.get(s)
        if wf is None:
            return 0, 0, False
        return wf.get(k)

    def get_raw(self, s: int, k: int) -> Tuple[int, bool]:
        if s < 0:
            return 0, False
        wf = self.wavefronts.get(s)
        if wf is None:
            return 0, False
        return wf.get_raw(k)

    def get_after_diff(self, s: int, diff: int, k: int) -> Tuple[int, int, bool]:
        """wfa_component.go:158-167 (uint32 underflow guard: diff > s)."""
        if diff > s:
            return 0, 0, False
        return self.get(s - diff, k)

    def delete(self, s: int, k: int) -> None:
        wf = self.wavefronts.get(s)
        if wf is not None:
            wf.delete(k)

    def print(self, wtr, name: str) -> None:
        """List all offsets for all scores (wfa_component.go:190-208)."""
        from .constants import type2str

        for s in sorted(self.wavefronts):
            wf = self.wavefronts[s]
            wtr.write(f"{name}{s}: k[{wf.lo}, {wf.hi}]: ")
            for k in range(wf.lo, wf.hi + 1):
                offset, tag, ok = wf.get(k)
                if ok:
                    wtr.write(f" k({k}):{offset}({type2str(tag)})")
            wtr.write("\n")


class Aligner:
    """Reference-exact gap-affine WFA aligner (oracle).

    One aligner per thread, reusable across pairs — mirrors wfa.go:79-140.
    """

    def __init__(
        self,
        penalties: Penalties = Penalties(),
        options: Options = Options(),
        adaptive: Optional[AdaptiveReductionOption] = None,
    ) -> None:
        self.p = penalties
        self.opt = options
        if adaptive is not None and adaptive.min_wf_len == 0:
            # same check the attach path runs (wfa.go:134-137): the
            # constructor shortcut must not smuggle in an invalid option
            raise ValueError("cutoff step should not be 0")
        self.ad = adaptive
        self.M = Component(is_m=True)
        self.I = Component()
        self.D = Component()

    def adaptive_reduction(self, ad: AdaptiveReductionOption) -> None:
        """wfa.go:134-140"""
        if ad.min_wf_len == 0:
            raise ValueError("cutoff step should not be 0")
        self.ad = ad

    # -- seeding (wfa.go:143-184) -----------------------------------------

    def _init_components(self, q: bytes, t: bytes) -> None:
        self.M.reset()
        self.I.reset()
        self.D.reset()
        m, n = len(t), len(q)
        M = self.M

        if q[0] == t[0]:
            tag, score = T_MATCH, 0
        else:
            tag, score = T_MISMATCH, self.p.mismatch
        M.set(score, 0, 1, tag)

        if not self.opt.global_alignment:
            for k in range(1, m):  # first row
                if q[0] == t[k]:
                    tag, score = T_MATCH, 0
                else:
                    tag, score = T_MISMATCH, self.p.mismatch
                M.set(score, k, k + 1, tag)
            for k in range(1, n):  # first column
                if q[k] == t[0]:
                    tag, score = T_MATCH, 0
                else:
                    tag, score = T_MISMATCH, self.p.mismatch
                M.set(score, -k, 1, tag)

    # -- main entry (wfa.go:196-268) ---------------------------------------

    def align(self, q: bytes, t: bytes) -> AlignmentResult:
        m, n = len(t), len(q)
        if n == 0 or m == 0:
            raise EmptySeqError("wfa: invalid empty sequence")
        if n > MAX_SEQ_LEN or m > MAX_SEQ_LEN:
            raise SeqTooLongError(
                f"wfa: sequences longer than {MAX_SEQ_LEN} are not supported"
            )

        qa = np.frombuffer(q, dtype=np.uint8)
        ta = np.frombuffer(t, dtype=np.uint8)

        self._init_components(q, t)

        Ak = m - n
        Aoffset = m
        M = self.M
        s = 0
        reduce_on = self.ad is not None
        min_wf_len = self.ad.min_wf_len if reduce_on else 0

        while True:
            if M.has_score(s):
                lo, hi = self._extend(qa, ta, s)
                offset, _, _ = M.get_after_diff(s, 0, Ak)
                if offset >= Aoffset:  # reached the end (wfa.go:235-239)
                    break
                if reduce_on and hi - lo + 1 >= min_wf_len:
                    self._reduce(qa, ta, s)
            s += 1
            self._next(n, m, s)

        min_s, last_k = s, Ak
        if not self.opt.global_alignment:
            min_s, last_k = self._backtrace_start_position(n, m, s)

        return self._back_trace(q, t, min_s, last_k)

    # -- WF_EXTEND (wfa.go:381-458) -----------------------------------------

    def _extend(self, qa: np.ndarray, ta: np.ndarray, s: int) -> Tuple[int, int]:
        wf = self.M.wavefronts[s]
        lo, hi = wf.lo, wf.hi
        len_q = len(qa)
        len_t = len(ta)

        for k in range(hi, lo - 1, -1):
            offset, _, ok = wf.get(k)
            if not ok:
                continue
            h = offset
            v = h - k
            if v <= 0 or v >= len_q or h >= len_t:  # bound check (wfa.go:404)
                continue
            # LCP of q[v:] and t[h:] bounded by the sequence ends.  The
            # reference's uint64-block fast path (wfa.go:411-435) computes
            # exactly this; vectorized here with numpy.
            limit = min(len_q - v, len_t - h)
            eq = qa[v : v + limit] == ta[h : h + limit]
            n_match = int(limit if eq.all() else np.argmin(eq))
            if n_match > 0:
                wf.increase(k, n_match)
        return lo, hi

    # -- wf-adaptive reduction (wfa.go:461-540) ------------------------------

    def _reduce(self, qa: np.ndarray, ta: np.ndarray, s: int) -> None:
        wf = self.M.wavefronts[s]
        lo, hi = wf.lo, wf.hi
        len_q = len(qa)
        len_t = len(ta)

        ds = []
        min_dist = _BIG
        for k in range(lo, hi + 1):
            offset, _, ok = wf.get(k)
            if not ok:
                ds.append(-1)
                continue
            h = offset
            v = h - k
            if v < 0 or v >= len_q or h >= len_t:  # NB: v<0 here (wfa.go:483)
                ds.append(-1)
                continue
            d = max(len_t - h, len_q - v)
            ds.append(d)
            if d < min_dist:
                min_dist = d

        _lo = lo
        _hi = hi
        max_dist_diff = self.ad.max_dist_diff
        update_lo = True
        found = False
        for i, d in enumerate(ds):
            if d < 0:
                continue
            if d - min_dist > max_dist_diff:
                found = True
                if update_lo:
                    _lo = lo + i + 1
                ds[i] = -1  # mark it
            else:
                update_lo = False
        if found:
            for i in range(len(ds) - 1, -1, -1):
                if ds[i] >= 0:
                    _hi = lo + i
                    break

        I, D = self.I, self.D
        for k in range(lo, _lo):
            wf.delete(k)
            I.delete(s, k)
            D.delete(s, k)
        for k in range(_hi + 1, hi + 1):
            wf.delete(k)
            I.delete(s, k)
            D.delete(s, k)
        wf.lo, wf.hi = _lo, _hi

    # -- WF_NEXT (wfa.go:549-700) ---------------------------------------------

    def _next(self, len_q: int, len_t: int, s: int) -> None:
        M, I, D, p = self.M, self.I, self.D, self.p

        lo_x, hi_x = M.k_range(s, p.mismatch)  # M[s-x]
        lo_o, hi_o = M.k_range(s, p.gap_open + p.gap_ext)  # M[s-o-e]
        lo_i, hi_i = I.k_range(s, p.gap_ext)  # I[s-e]
        lo_d, hi_d = D.k_range(s, p.gap_ext)  # D[s-e]

        hi = min(len_t - 1, max(hi_x, hi_o, hi_i, hi_d) + 1)
        lo = max(-(len_q - 1), min(lo_x, lo_o, lo_i, lo_d) - 1)

        oe = p.gap_open + p.gap_ext
        e = p.gap_ext
        x = p.mismatch

        for k in range(lo, hi + 1):
            # insertion (wfa.go:578-608)
            v1, _, from_m = M.get_after_diff(s, oe, k - 1)
            v2, _, from_i = I.get_after_diff(s, e, k - 1)
            if from_m and v1 > len_t:
                from_m = False
                v1 = 0
            if from_i and v2 > len_t:
                from_i = False
                v2 = 0
            Isk = max(v1, v2) + 1
            updated_i = from_m or from_i
            if updated_i:
                if from_m and from_i:
                    tag_i = T_INS_OPEN if v1 >= v2 else T_INS_EXT
                elif from_m:
                    tag_i = T_INS_OPEN
                else:
                    tag_i = T_INS_EXT
                I.set(s, k, Isk, tag_i)
            else:
                Isk = 0
                tag_i = 0

            # deletion (wfa.go:612-643)
            v1, _, from_m = M.get_after_diff(s, oe, k + 1)
            v2, _, from_d = D.get_after_diff(s, e, k + 1)
            if from_m and v1 - k > len_q:
                from_m = False
                v1 = 0
            if from_d and v2 - k > len_q:
                from_d = False
                v2 = 0
            Dsk = max(v1, v2)
            updated_d = from_m or from_d
            if updated_d:
                if from_m and from_d:
                    tag_d = T_DEL_OPEN if v1 >= v2 else T_DEL_EXT
                elif from_m:
                    tag_d = T_DEL_OPEN
                else:
                    tag_d = T_DEL_EXT
                D.set(s, k, Dsk, tag_d)
            else:
                Dsk = 0
                tag_d = 0

            # mismatch / M (wfa.go:648-698)
            v1, _, from_m = M.get_after_diff(s, x, k)
            if from_m and (v1 > len_t or v1 - k > len_q):
                from_m = False
                v1 = 0
            Msk = max(Isk, Dsk, v1 + 1)
            if updated_i or updated_d or from_m:
                # Tie-breaking: mismatch preferred, then I, then D
                # (wfa.go:655-693).
                if from_m and Msk == v1 + 1:
                    tag_m = T_MISMATCH
                elif updated_i and Msk == Isk:
                    tag_m = tag_i
                else:
                    tag_m = tag_d
                M.set(s, k, Msk, tag_m)

    # -- backtrace: shared storage-agnostic implementation ------------------

    def _backtrace_start_position(
        self, len_q: int, len_t: int, s: int
    ) -> Tuple[int, int]:
        return backtrace_start_position(self.M, len_q, len_t, s)

    def _back_trace(self, q: bytes, t: bytes, s: int, Ak: int) -> AlignmentResult:
        return back_trace(
            self.M, self.I, self.D, self.p, self.opt.global_alignment,
            q, t, s, Ak,
        )

    def plot(self, q: bytes, t: bytes, component=None,
             not_change_to_match: bool = False, max_score: int = -1) -> str:
        """Render a component's wavefronts as the reference's score/arrow
        table ((*Aligner).Plot, wfa_component_plot.go:41); call after
        :meth:`align` on the same pair."""
        from .plot import plot as _plot

        return _plot(self, q, t, component, not_change_to_match, max_score)


def align(
    q: bytes,
    t: bytes,
    penalties: Penalties = Penalties(),
    options: Options = Options(),
    adaptive: Optional[AdaptiveReductionOption] = None,
) -> AlignmentResult:
    """One-shot convenience wrapper around :class:`Aligner`."""
    return Aligner(penalties, options, adaptive).align(q, t)
