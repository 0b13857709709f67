"""Alignment result: CIGAR op-runs, stats and text rendering.

Semantics mirror the reference's AlignmentResult (wfa_cigar.go) exactly:

* ops are appended end-to-front during backtrace, then reversed and merged
  by :meth:`AlignmentResult.process` (wfa_cigar.go:136-214);
* stats (align_len/matches/gaps/gap_regions) are computed only between the
  first and the last ``M`` run (wfa_cigar.go:171-211);
* rendering conventions are the package's own (inverted vs SAM):
  ``I`` consumes target, ``D``/``H`` consume query (wfa_cigar.go:286-330).

The port's own copy of :mod:`wfa_tpu.cigar`.  Device results decode
lazily from either token stream the engine ships: an edit-only stream
(``(toks, q, t)``, match runs rebuilt by :meth:`_decode_edit_tokens`) or a
full one (match runs included, op table from the port's
:mod:`.device_backtrace`).
"""

from __future__ import annotations

from typing import List, Tuple


class AlignmentResult:
    """Score, matched-region coordinates, stats and CIGAR ops.

    Coordinates are 1-based and exclude flanking clippings/insertions
    (wfa_cigar.go:36-37).
    """

    __slots__ = (
        "_ops",
        "score",
        "_t_begin",
        "_t_end",
        "_q_begin",
        "_q_end",
        "_align_len",
        "_matches",
        "_gaps",
        "_gap_regions",
        "_processed",
        "_raw_tokens",
        "_device_coords",
        "global_alignment",
        "error",
    )

    def __init__(self, global_alignment: bool = True) -> None:
        self._ops: List[Tuple[str, int]] = []
        self.score = 0
        self._t_begin = 0
        self._t_end = 0
        self._q_begin = 0
        self._q_end = 0
        self._align_len = 0
        self._matches = 0
        self._gaps = 0
        self._gap_regions = 0
        self._processed = False
        # packed device op tokens (emission order), decoded lazily;
        # stats and matched-region coordinates are then derived from the
        # decoded ops exactly as the reference's process() derives stats
        # (the device ships only score/overflow/extents — 8 fewer meta
        # columns of download per pair)
        self._raw_tokens = None
        self._device_coords = False
        self.global_alignment = global_alignment
        # per-pair failure (reference: Align returns (nil, err) per call,
        # wfa.go:204-209).  Batched pipelines must not let one bad pair
        # poison its batch, so the error rides on the result instead.
        self.error: Exception | None = None

    @classmethod
    def from_device(cls, ga: bool, score: int, tokens) -> "AlignmentResult":
        """Fast constructor for device-decoded batches (the pipeline
        builds thousands of these per batch):
        ``tokens`` is the packed device token view, decoded lazily —
        stats and matched-region coordinates come from the decoded ops
        on first access."""
        res = cls.__new__(cls)
        res._ops = []
        res.score = score
        res._q_begin = res._q_end = res._t_begin = res._t_end = 0
        res._align_len = res._matches = res._gaps = res._gap_regions = 0
        res._processed = False
        res._raw_tokens = tokens
        res._device_coords = True
        res.global_alignment = ga
        res.error = None
        return res

    # stats and matched-region coordinates: plain attributes for the
    # host/oracle path, lazily derived from the decoded ops for device
    # results (the properties trigger the decode on first access)
    def _stat(name):  # noqa: N805 - tiny descriptor factory
        priv = "_" + name

        def get(self):
            if self._raw_tokens is not None:
                self.process()
            return getattr(self, priv)

        def set_(self, value):
            setattr(self, priv, value)

        return property(get, set_)

    t_begin = _stat("t_begin")
    t_end = _stat("t_end")
    q_begin = _stat("q_begin")
    q_end = _stat("q_end")
    align_len = _stat("align_len")
    matches = _stat("matches")
    gaps = _stat("gaps")
    gap_regions = _stat("gap_regions")
    del _stat

    @classmethod
    def failed(cls, error: Exception) -> "AlignmentResult":
        """Result carrying a per-pair input error (empty/too-long seq)."""
        res = cls()
        res.error = error
        res._processed = True
        return res

    @property
    def ops(self) -> List[Tuple[str, int]]:
        if self._raw_tokens is not None:
            self.process()
        return self._ops

    @ops.setter
    def ops(self, value) -> None:
        self._ops = value

    def set_device_tokens(self, tokens) -> None:
        """Attach a packed device token row (code << 28 | run, emission
        order, zeros = empty slots); op decoding happens on first access —
        stats come from the device (device_backtrace.device_stats)."""
        self._raw_tokens = tokens
        self._processed = False

    # -- building (used by backtrace) ------------------------------------

    def add_n(self, op: str, n: int) -> None:
        """Append an op run (wfa_cigar.go:118-124)."""
        self.ops.append((op, n))

    # -- post-processing ---------------------------------------------------

    def process(self) -> None:
        """Reverse, merge and compute stats (wfa_cigar.go:136-214)."""
        if self._processed:
            return
        if self._raw_tokens is not None:
            # decode the device token row: nonzero tokens, reversed into
            # final order, merged below; stats already set by the device
            import numpy as np

            from .device_backtrace import OP_CHARS

            if isinstance(self._raw_tokens, tuple):
                # edit-only stream: reconstruct the match runs from the
                # sequences (see _decode_edit_tokens)
                toks, q, t = self._raw_tokens
                decoded = self._decode_edit_tokens(toks, q, t)
            else:
                toks = self._raw_tokens
                shift = 12 if toks.dtype == np.int16 else 28
                mask = (1 << shift) - 1
                toks = toks[toks != 0][::-1]
                # normalize the edit-mode split extension codes (5 -> I,
                # 6 -> D); plain streams never contain them
                decoded = [
                    (OP_CHARS[c] if c < len(OP_CHARS)
                     else "I" if c == 5 else "D" if c == 6 else ".",
                     int(tk & mask))
                    for tk in toks
                    for c in (int(tk) >> shift,)
                ]
            self._raw_tokens = None
            merged: List[Tuple[str, int]] = []
            for op, n in decoded:
                if merged and merged[-1][0] == op:
                    merged[-1] = (op, merged[-1][1] + n)
                else:
                    merged.append((op, n))
            self._ops = merged
            self._processed = True
            if self._device_coords:
                self._derive_from_ops()
            return
        self._ops.reverse()

        merged: List[Tuple[str, int]] = []
        for op, n in self._ops:
            if merged and merged[-1][0] == op:
                merged[-1] = (op, merged[-1][1] + n)
            else:
                merged.append((op, n))
        self.ops = merged

        # stats between the first and last 'M' runs; Go defaults begin/end
        # to 0 when no 'M' exists (wfa_cigar.go:171-187).
        begin = 0
        end = 0
        for i, (op, _) in enumerate(self.ops):
            if op == "M":
                begin = i
                break
        for i in range(len(self.ops) - 1, -1, -1):
            if self.ops[i][0] == "M":
                end = i
                break

        align_len = matches = gaps = gap_regions = 0
        for i in range(begin, end + 1):
            op, n = self.ops[i]
            align_len += n
            if op == "M":
                matches += n
            elif op in ("I", "D"):
                gaps += n
                gap_regions += 1
        self.align_len = align_len
        self.matches = matches
        self.gaps = gaps
        self.gap_regions = gap_regions
        self._processed = True

    def _derive_from_ops(self) -> None:
        """Stats (wfa_cigar.go:171-211) AND matched-region coordinates
        from the merged final ops — for device results, whose download
        carries only score/overflow/extents.  The coordinates follow
        the reference's backtrace bookkeeping (wfa.go:840-863): 1-based
        first/last matched positions, 0 when no M run exists."""
        v = h = 0
        qb = qe = tb = te = 0
        align_len = matches = gaps = gap_regions = 0
        begin = end = 0  # stats span defaults to ops[0:1] when no M
        first = True
        for i, (op, n) in enumerate(self._ops):
            if op == "M":
                if first:
                    qb, tb = v + 1, h + 1
                    begin = i
                    first = False
                v += n
                h += n
                qe, te = v, h
                end = i
            elif op == "X":
                v += n
                h += n
            elif op == "I":
                h += n
            else:  # D, H consume query
                v += n
        for i in range(begin, min(end + 1, len(self._ops))):
            op, n = self._ops[i]
            align_len += n
            if op == "M":
                matches += n
            elif op in ("I", "D"):
                gaps += n
                gap_regions += 1
        self._q_begin, self._q_end = qb, qe
        self._t_begin, self._t_end = tb, te
        self._align_len = align_len
        self._matches = matches
        self._gaps = gaps
        self._gap_regions = gap_regions

    @staticmethod
    def _decode_edit_tokens(toks, q: bytes, t: bytes):
        """Decode an edit-only device token stream (global alignment):
        the stream carries only X/I/D/H ops (match runs dropped on
        device — compact_tokens_flat_u8 drop_m); every match run is the
        LCP of the remaining suffixes at its junction, because the
        forward pass extends greedily and maximally (wfa.go:411-454) —
        a run ends exactly where the diagonal's bases first differ.
        Gap-EXTENSION steps carry split codes (CODE_IE/CODE_DE): the
        cell between two extension ops is an I/D-component cell, which
        never extends, so no match run may be inserted there even when
        the suffixes happen to agree.

        The final position must land exactly on (len(q), len(t)) — any
        divergence is a decoder/kernel bug, not a data condition."""
        import numpy as np

        shift = 12 if toks.dtype == np.int16 else 28
        mask = (1 << shift) - 1
        toks = toks[toks != 0][::-1]
        codes = (toks.astype(np.int32) >> shift).tolist()
        runs = (toks.astype(np.int32) & mask).tolist()
        ops: List[Tuple[str, int]] = []
        append = ops.append
        v = h = 0
        nq, nt = len(q), len(t)
        for code, run in zip(codes, runs):
            if code != 5 and code != 6:  # match run may precede this op
                lim = min(nq - v, nt - h)
                n = 0
                while n < lim:
                    step = min(128, lim - n)
                    if q[v + n:v + n + step] == t[h + n:h + n + step]:
                        n += step
                        continue
                    while q[v + n] == t[h + n]:
                        n += 1
                    break
                if n:
                    append(("M", n))
                    v += n
                    h += n
            if code == 1:  # X
                append(("X", run))
                v += run
                h += run
            elif code == 2 or code == 5:  # I consumes target
                append(("I", run))
                h += run
            else:  # D (3/6) and H (4) consume query
                append(("D" if code != 4 else "H", run))
                v += run
        lim = min(nq - v, nt - h)
        n = 0
        while n < lim:
            step = min(128, lim - n)
            if q[v + n:v + n + step] == t[h + n:h + n + step]:
                n += step
                continue
            while q[v + n] == t[h + n]:
                n += 1
            break
        if n:
            append(("M", n))
            v += n
            h += n
        assert v == nq and h == nt, (
            "edit-token reconstruction diverged: "
            f"({v},{h}) != ({nq},{nt})")
        return ops

    def _trimmed_ops(self) -> List[Tuple[str, int]]:
        """Ops between first and last 'M' inclusive (wfa_cigar.go:217-233)."""
        start = -1
        end = -1
        for i, (op, _) in enumerate(self.ops):
            if op == "M":
                start = i
                break
        for i in range(len(self.ops) - 1, -1, -1):
            if self.ops[i][0] == "M":
                end = i
                break
        if start < 0:
            raise ValueError("no aligned (M) region to trim to")
        return self.ops[start : end + 1]

    def cigar(self, only_aligned_region: bool = False) -> str:
        """Render the CIGAR string (wfa_cigar.go:236-255)."""
        self.process()
        ops = self._trimmed_ops() if only_aligned_region else self.ops
        return "".join(f"{n}{op}" for op, n in ops)

    def alignment_text(
        self, q: bytes, t: bytes, only_aligned_region: bool = False
    ) -> Tuple[bytes, bytes, bytes]:
        """Render the 3-row alignment text (wfa_cigar.go:259-333)."""
        self.process()
        ops = self.ops
        if only_aligned_region:
            q = q[self.q_begin - 1 : self.q_end]
            t = t[self.t_begin - 1 : self.t_end]
            ops = self._trimmed_ops()

        Q = bytearray()
        A = bytearray()
        T = bytearray()
        v = h = 0
        for op, n in ops:
            if op == "M":
                Q += q[v : v + n]
                A += b"|" * n
                T += t[h : h + n]
                v += n
                h += n
            elif op == "X":
                Q += q[v : v + n]
                A += b" " * n
                T += t[h : h + n]
                v += n
                h += n
            elif op == "I":  # consumes target
                Q += b"-" * n
                A += b" " * n
                T += t[h : h + n]
                h += n
            elif op in ("D", "H"):  # consume query
                Q += q[v : v + n]
                A += b" " * n
                T += b"-" * n
                v += n
        return bytes(Q), bytes(A), bytes(T)

    # -- misc ---------------------------------------------------------------

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"AlignmentResult(score={self.score}, cigar={self.cigar()!r}, "
            f"q[{self.q_begin},{self.q_end}] t[{self.t_begin},{self.t_end}], "
            f"len={self.align_len} matches={self.matches} gaps={self.gaps} "
            f"gap_regions={self.gap_regions})"
        )
