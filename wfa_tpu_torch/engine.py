"""Batched score-loop engine, PyTorch port of :mod:`wfa_tpu.engine`.

The main path, global or semi-global: host pack -> upload ->
``_unpack2`` -> kernel K1 (``kernel_engine.run_batch``, the per-pair CUDA
score loop, with its fused end finder in semi-global mode) -> kernel K2
(``device_backtrace.device_backtrace``) from the end K1 reports -> token
compaction -> meta bytes -> host decode in :class:`DeviceResult`.  Long
global reads may take K1-long instead (``engine="long"``,
``kernel_engine.run_batch_long``: value-rebased int16 aux plus per-row
bases), which K2 reads with those bases.

``run_batch_plain`` is the plain PyTorch version of K1: a lockstep
transcription of the JAX engine's ``_run_batch_impl`` that extends through
the precomputed stop tables (``_stop_tables``), while K1 compares sequence
bytes directly, so the two extension mechanisms check each other.
``run_batch_long_plain`` is K1-long's and ``run_batch_kw_plain`` K1-kw's:
the same loop, its aux rebased afterwards.  Global reads whose longest
lies in (4095 - k_win, 4096] may take K1-kw (``engine="kw"``,
``kernel_engine.run_batch_kw``: a KW-column window of each aux row,
value-rebased int16 cells, and one ``sbase`` word a row), which K2 reads
through those words.

Cells keep the reference encoding ``offset << 3 | tag`` (0 = absent), and
every tensor that leaves a function has the JAX function's layout, so the
tests compare the two packages value for value.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import native, trace
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
    AdaptiveReductionOption,
    EmptySeqError,
    Options,
    Penalties,
    SeqTooLongError,
)
from .oracle import Aligner as OracleAligner

_BIG = 1 << 30
_I32 = torch.int32

# largest rebased offset an int16 aux cell of the long-read mode holds
MAX_REBASED = 4095


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    penalties: Penalties = Penalties()
    global_alignment: bool = True
    adaptive: Optional[AdaptiveReductionOption] = None
    k_win: int = 128  # diagonal window width
    s_cap: int = 256  # max score + 1
    # phase 1 of the two-phase semi-global route: run scores
    # 0 .. s_cap - 2 and keep the state (run_batch_plain)
    prefix: bool = False
    # K1-kw (engine "kw", global only): the aux keeps a KW-column window
    # of each score row, row- and value-rebased (run_batch_kw_plain)
    aux_kw: Optional[int] = None


def edit_only(cfg: EngineConfig) -> bool:
    """Whether a batch ships the edit-only token stream (match runs
    dropped, rebuilt host-side): global alignment unless
    ``WFA_EDIT_TOKENS=0``, the gate of ``wfa_tpu.engine``."""
    return (cfg.global_alignment
            and os.environ.get("WFA_EDIT_TOKENS") != "0")


def config_from_jax(cfg) -> EngineConfig:
    """The port's config for a :class:`wfa_tpu.engine.EngineConfig`
    (read by attribute, so this module never imports JAX).  Raises
    NotImplementedError for the JAX engine's modes the port lacks."""
    for name in ("w_win", "v_win"):
        if getattr(cfg, name, None) is not None:
            raise NotImplementedError(f"EngineConfig.{name} is not ported")
    return EngineConfig(
        penalties=cfg.penalties, global_alignment=cfg.global_alignment,
        adaptive=cfg.adaptive, k_win=cfg.k_win, s_cap=cfg.s_cap,
        prefix=bool(getattr(cfg, "prefix", False)),
        aux_kw=getattr(cfg, "aux_kw", None))


def score_stride(cfg: EngineConfig) -> int:
    """The stride g of a global score loop: the greatest common divisor of
    the penalties, which divides every score a wavefront can hold, so that
    only the rows of scores 0, g, 2g, ... can hold a cell.  1 for
    semi-global alignment (the two-phase route's S0 counts score steps,
    and the end finder's rows are K1-semi's own) and where the mismatch
    seed row lies past the cap."""
    p = cfg.penalties
    if not cfg.global_alignment or cfg.prefix or p.mismatch >= cfg.s_cap:
        return 1
    return max(1, math.gcd(p.mismatch, p.gap_open, p.gap_ext))


def loop_config(cfg: EngineConfig, g: int) -> EngineConfig:
    """The config a global score loop and its backtrace run at stride
    ``g`` (:func:`score_stride`): the penalties divided by g, and
    (s_cap - 2) // g + 2 rows, so that the last row the loop tests,
    s_cap - 2, keeps the same multiples of g.  Row r then holds score g r
    with the same cells, tags, bands and reductions: WFA's recurrences
    read the penalties only as score differences, and the wf-adaptive
    reduce reads offsets and distances."""
    if g == 1:
        return cfg
    p = cfg.penalties
    return dataclasses.replace(
        cfg, penalties=Penalties(p.mismatch // g, p.gap_open // g,
                                 p.gap_ext // g),
        s_cap=(cfg.s_cap - 2) // g + 2)


def engine_kw(engine: str, k_win: int) -> Optional[int]:
    """KW of an ``"auto:kw<KW>"`` or ``"pallas:kw<KW>"`` engine string,
    capped at ``k_win`` as ``wfa_tpu.engine.BatchAligner`` caps it
    (engine.py:1462-1485); None for any other engine."""
    for prefix in ("auto:kw", "pallas:kw"):
        if engine.startswith(prefix):
            return min(int(engine[len(prefix):]), k_win)
    return None


def check_aux_kw(cfg: EngineConfig, Ltb: int) -> int:
    """``cfg.aux_kw`` after the guards of the TPU kernel's KW mode
    (wfa_tpu/pallas_engine.py:1064-1070): global alignment, 0 < KW <=
    k_win, KW a multiple of 128 (a TPU lane-tile rule, kept so that both
    packages take the same engine strings), the row base (k_win - KW) // 32
    within sbase's 5 low bits, and value bases below 2**26.  Raises
    ValueError."""
    KW, K = cfg.aux_kw, cfg.k_win
    if not cfg.global_alignment:
        raise ValueError("aux_kw (engine 'kw') runs global alignment only")
    if KW is None or not 0 < KW <= K or KW % 128:
        raise ValueError(f"aux_kw {KW} must be a multiple of 128 in "
                         f"(0, k_win {K}]")
    if (K - KW) // 32 > 31:
        raise ValueError(f"aux_kw {KW}: the row base (k_win - KW) // 32 = "
                         f"{(K - KW) // 32} passes 31")
    if Ltb >= 1 << 26:
        raise ValueError(f"aux_kw: Ltb {Ltb} passes 2**26")
    return KW


def resolve_device(device) -> torch.device:
    """The device a :class:`BatchAligner` or pipeline runs on: the card
    unless the caller asks for the CPU.  A CUDA device where none is
    available raises; nothing falls back to the CPU quietly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "wfa_tpu_torch runs on a CUDA card by default and none is "
            "available here; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return dev


# the uploads' stream of each card (:func:`upload`), made at first use
_UP_STREAMS: dict = {}
_UP_LOCK = threading.Lock()


def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``a``, a host array in pageable memory, on ``dev``.  On a card the
    copy runs on that card's upload stream: a copy from pageable memory
    synchronises its stream, so on the launches' stream it would wait
    for every batch launched before it.  The copy has landed when this
    returns, and the launches on the thread's current stream then read
    the tensor (``record_stream`` keeps the allocator from reusing it
    before they have run).  Every upload of the port goes through here:
    a batch's rows, or a mesh shard's (:meth:`BatchAligner._upload`), and
    the rows of ``parallel``'s scores-only steps."""
    t = torch.from_numpy(a)
    if dev.type != "cuda":
        return t.to(dev)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    with _UP_LOCK:
        stream = _UP_STREAMS.get(idx)
        if stream is None:
            stream = _UP_STREAMS[idx] = torch.cuda.Stream(idx)
    with torch.cuda.stream(stream):
        t = t.to(dev)
    t.record_stream(torch.cuda.current_stream(dev))
    return t


def window_origin(qlen: int, tlen: int, k_win: int,
                  global_alignment: bool) -> int:
    """Fixed per-pair window origin k0 (column 0's diagonal)."""
    if not global_alignment:
        return -(qlen - 1)
    ak = tlen - qlen
    return ak // 2 - k_win // 2


def _pad_len(n: int) -> int:
    """Pad buffer lengths to coarse steps (same-bucket chunks share
    shapes)."""
    g = 128 if n <= 4096 else 2048
    return ((n + g - 1) // g) * g


# columns of the per-pair meta header of the "mtb" byte stream
META_COLS = ("score", "overflow", "trim_len", "n_long")
M_SCORE, M_OVF, M_TRIM, M_LONG = range(4)


def _token_plan(s_cap: int, penalties, Lq: int, Ltb: int):
    """(token_shift, compact): 16-bit tokens whenever run lengths fit 12
    bits; compaction whenever the emission stream fits 2**16 slots."""
    from .device_backtrace import iter_capacity

    token_shift = 12 if max(Lq, Ltb) < (1 << 12) else 28
    ns_stream = 2 * iter_capacity(s_cap, penalties) + 5
    return token_shift, ns_stream <= (1 << 16)


# ---------------------------------------------------------------------------
# host pack and the tensors the tests hand to both packages

_ACGT_LUT = np.full(256, 255, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _ACGT_LUT[_b] = _i
_ACGT_LUT0 = _ACGT_LUT.copy()
_ACGT_LUT0[0] = 0
_ACGT_INV = np.array(list(b"ACGT"), np.uint8)


def _pack2(arr: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """2-bit-pack a byte matrix whose in-bounds ([lo, hi) per row) bytes
    are pure ACGT (4 bases/byte, low pairs first); None when another
    symbol is in bounds.  Pad bytes pack as code 0 and are re-zeroed by
    ``_unpack2``'s masks."""
    codes = _ACGT_LUT0[arr]
    # per-row nonzero counts: a batch-wide sum could balance an in-bounds
    # NUL in one row against out-of-bounds junk in another
    row_nz = np.count_nonzero(arr, axis=1)
    if not (np.array_equal(row_nz, np.clip(hi - lo, 0, None))
            and int(codes.max(initial=0)) <= 3):
        codes = _ACGT_LUT[arr]
        pos = np.arange(arr.shape[1], dtype=np.int32)
        inb = (pos >= lo[:, None]) & (pos < hi[:, None])
        codes = np.where(inb, codes, 0)
        if codes.max(initial=0) > 3:
            return None
    c = codes.reshape(arr.shape[0], -1, 4)
    return (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
            | (c[:, :, 3] << 6)).astype(np.uint8)


def _pack_all(pairs: Sequence[Tuple[bytes, bytes]], k_win: int,
              need_raw: bool = True, global_alignment: bool = True):
    """Padded row matrices and their 2-bit uploads for a batch:
    (qb, tbuf, qlen, tlen, toff, Lq, Ltb, qp, tp), the same tuple as
    ``wfa_tpu.engine.BatchAligner._pack_all``.  qp/tp are None when the
    batch has non-ACGT bytes; qb/tbuf are None when ``need_raw`` is False
    and the native packer packed the batch directly, and qp/tp are then
    the two column ranges of one matrix."""
    B = len(pairs)
    qlen = np.fromiter((len(q) for q, _ in pairs), np.int32, B)
    tlen = np.fromiter((len(t) for _, t in pairs), np.int32, B)
    if global_alignment:
        ak = tlen - qlen
        # floor division on the host: C++ `/` would truncate toward zero
        toff = (k_win // 2 - ak // 2).astype(np.int32)
    else:  # the window starts at the first-column seeds' diagonal
        toff = qlen - 1
    Lq = _pad_len(int(qlen.max()))
    Ltb = _pad_len(max(int((toff + tlen).max()), 1))

    qs = [q for q, _ in pairs]
    ts = [t for _, t in pairs]
    lib = native.load()
    if lib is not None and not need_raw:
        # both halves packed into one [B, Lq/4 + Ltb/4] matrix: _seq_lens
        # hands it on whole
        Wq = Lq // 4
        seq = np.empty((B, Wq + Ltb // 4), np.uint8)
        qp = native.pack_direct(qs, qlen, None, Lq, out=seq[:, :Wq])
        tp = (native.pack_direct(ts, tlen, toff, Ltb, out=seq[:, Wq:])
              if qp is not None else None)
        if tp is not None:
            return None, None, qlen, tlen, toff, Lq, Ltb, qp, tp
    if lib is not None:
        qb, qp = native.build_and_pack(qs, qlen, None, Lq)
        tbuf, tp = native.build_and_pack(ts, tlen, toff, Ltb)
        if qp is None or tp is None:
            qp = tp = None
        return qb, tbuf, qlen, tlen, toff, Lq, Ltb, qp, tp
    pad = b"\0" * (Ltb + 1)
    qb = np.frombuffer(b"".join(q.ljust(Lq, b"\0") for q in qs),
                       np.uint8).reshape(B, Lq)
    # overflow pairs (toff < 0) get truncated rows; they are never read
    tbuf = np.frombuffer(
        b"".join((pad[:max(int(o), 0)] + t)[:Ltb].ljust(Ltb, b"\0")
                 for o, t in zip(toff, ts)), np.uint8).reshape(B, Ltb)
    qp = _pack2(qb, np.zeros_like(qlen), qlen)
    tp = _pack2(tbuf, toff, toff + tlen) if qp is not None else None
    if tp is None:
        qp = None
    return qb, tbuf, qlen, tlen, toff, Lq, Ltb, qp, tp


def inputs_from_packed(packed, device) -> tuple:
    """Tensors on ``device`` from a packed batch with its raw rows — the
    7-tuple of ``wfa_tpu.engine.BatchAligner.pack_batch`` or the 9-tuple
    of ``_pack_all`` (of either package): (qb uint8[B, Lq], tbuf
    uint8[B, Ltb], qlen, tlen, toff int32[B], Lq, Ltb)."""
    qb, tbuf, qlen, tlen, toff, Lq, Ltb = packed[:7]
    dev = torch.device(device)
    rows = [torch.as_tensor(np.ascontiguousarray(a), device=dev)
            for a in (qb, tbuf)]
    lens = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
            for a in (qlen, tlen, toff)]
    return (*rows, *lens, int(Lq), int(Ltb))


def _unpack2(pk: torch.Tensor, L: int, valid_lo: torch.Tensor,
             valid_hi: torch.Tensor) -> torch.Tensor:
    """Invert the 2-bit pack: uint8[B, L//4] -> uint8[B, L], zeroed
    outside [valid_lo, valid_hi) per row."""
    shifts = torch.arange(4, device=pk.device, dtype=torch.uint8) * 2
    c = (pk[:, :, None] >> shifts) & 3
    c = c.reshape(pk.shape[0], L).long()
    base = torch.as_tensor(_ACGT_INV, device=pk.device)[c]
    pos = torch.arange(L, device=pk.device, dtype=_I32)[None, :]
    ok = (pos >= valid_lo[:, None]) & (pos < valid_hi[:, None])
    return torch.where(ok, base, torch.zeros_like(base))


# ---------------------------------------------------------------------------
# the inputs of the score loop


def _masked_min(vals, mask):
    return torch.where(mask, vals, _BIG).amin(dim=-1)


def _masked_max(vals, mask):
    return torch.where(mask, vals, -_BIG).amax(dim=-1)


def _seed_rows(qb, tbuf, qlen, tlen, toff, *, mismatch: int, K: int,
               Ltb: int, global_alignment: bool = True):
    """Dense seed rows for scores 0 and ``mismatch`` (wfa.go:143-184):
    ((row0, lo0, hi0, ex0), (rowx, lox, hix, exx)), rows int32[B, K] in
    the fixed-origin window layout; match seeds go to row 0, mismatch
    seeds to row x, and with mismatch == 0 both land in row0 and rowx is
    empty.  Global: one cell, diagonal 0 at offset 1.  Semi-global: the
    first row and column, k in [-(qlen-1), tlen-1] (k0 == -(qlen-1));
    k >= 0 at offset k+1 from q[0] == t[k], k < 0 at offset 1 from
    q[-k] == t[0], built by indexing rather than the TPU's log-shift
    doublings (equal to them whenever the window spans the query)."""
    B = qb.shape[0]
    dev = qb.device
    k0 = -toff.to(_I32)
    iota = torch.arange(K, device=dev, dtype=_I32)[None, :]
    ks = k0[:, None] + iota
    rows_b = torch.arange(B, device=dev)
    t0 = tbuf[rows_b, toff.long().clamp(0, Ltb - 1)]
    if global_alignment:
        eq = (qb[:, 0] == t0)[:, None]
        off = torch.ones_like(ks)
        in_range = ks == 0
    else:
        # t[k] lives at buffer column k + toff == j; q[-k] = q[toff - j]
        t_at_k = torch.zeros((B, K), dtype=torch.uint8, device=dev)
        n = min(K, Ltb)
        t_at_k[:, :n] = tbuf[:, :n]
        mk = (-ks).clamp(0, qb.shape[1] - 1).long()
        q_at_mk = torch.gather(qb, 1, mk)
        eq = torch.where(ks >= 0, qb[:, :1] == t_at_k, q_at_mk == t0[:, None])
        off = torch.where(ks >= 0, ks + 1, 1)
        in_range = ks <= (tlen.to(_I32) - 1)[:, None]
    cell = off << TYPE_BITS
    zero = torch.zeros((B, K), dtype=_I32, device=dev)
    seed_eq = torch.where(in_range & eq, cell | T_MATCH, zero)
    seed_ne = torch.where(in_range & ~eq, cell | T_MISMATCH, zero)
    rows = ((seed_eq + seed_ne, zero) if mismatch == 0
            else (seed_eq, seed_ne))
    out = []
    for row in rows:
        any_set = (row > 0).any(dim=1)
        lo = torch.where(any_set, _masked_min(ks, row > 0), _BIG)
        hi = torch.where(any_set, _masked_max(ks, row > 0), -_BIG)
        out.append((row, lo.to(_I32), hi.to(_I32), any_set))
    return out[0], out[1]


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros of 32-bit words, bit-exact with ``lax.clz``.
    ``x`` is int32 (a word with bit 31 set is negative and has clz 0) or
    int64 holding a 32-bit pattern in [0, 2**32); clz(0) = 32."""
    u = x.long() & 0xFFFFFFFF
    n = torch.zeros_like(u)
    for b in (16, 8, 4, 2, 1):
        top_clear = u < (1 << (32 - b))
        n = n + torch.where(top_clear, b, 0)
        u = torch.where(top_clear, u << b, u)
    return torch.where((x.long() & 0xFFFFFFFF) == 0, 32, n).to(_I32)


def _stop_tables(qb, tbuf, qlen, tlen, toff, K: int, Lq: int, Ltb: int):
    """Extension stop tables, equal to ``wfa_tpu.engine._stop_tables``.

    stop[b, j, c] = 1 unless v = c - j and h = c - toff are in bounds and
    q[v] == t[h]; a match run from column c is (first stop at or after
    c) - c.  Returns words int32[B, K, Lw] (stop bits packed 32 per word,
    big-endian within the word) and fsa int32[B, K, Lw] (the absolute
    column of the first stop in any word after w).  ``q_sh`` is built by
    indexing, not by the TPU's concat-and-shift doublings."""
    B = qb.shape[0]
    dev = qb.device
    Lwc = (Ltb + 32) // 32  # >= 1 stop column beyond every toff + tlen
    Lc = Lwc * 32
    n = min(Lq, Lc)
    qpad = torch.zeros((B, K + Lc), dtype=torch.uint8, device=dev)
    qpad[:, K:K + n] = qb[:, :n]
    cs = torch.arange(Lc, device=dev, dtype=_I32)
    tpad = torch.zeros((B, Lc), dtype=torch.uint8, device=dev)
    tpad[:, :Ltb] = tbuf
    csb = cs[None, None, :]
    # bits 30..0 sum exactly in int32; bit 31 is or-ed in as the sign bit
    w31 = (1 << (30 - torch.arange(31, device=dev, dtype=_I32))).to(_I32)
    sign = torch.tensor(-(1 << 31), dtype=_I32, device=dev)
    # a chunk of diagonals at a time keeps the [B, chunk, Lc] temporaries
    # near 2**26 cells at full-span widths
    kc = max(1, min(K, (1 << 26) // max(1, B * Lc)))
    parts = []
    for j0 in range(0, K, kc):
        js = torch.arange(j0, min(K, j0 + kc), device=dev, dtype=_I32)
        q_sh = qpad[:, (K + cs[None, :] - js[:, None]).long()]  # [B, kc, Lc]
        vs = (cs[None, :] - js[:, None])[None]
        valid = ((vs >= 0) & (vs < qlen[:, None, None])
                 & (csb >= toff[:, None, None])
                 & (csb < (toff + tlen)[:, None, None]))
        stop = ~(valid & (q_sh == tpad[:, None, :]))
        bits = stop.reshape(B, len(js), Lwc, 32).to(_I32)
        w = (bits[..., 1:] * w31).sum(dim=-1, dtype=_I32)
        parts.append(torch.where(bits[..., 0] > 0, w | sign, w))
    words = torch.cat(parts, dim=1)
    wpos = torch.where(
        words != 0,
        torch.arange(Lwc, device=dev, dtype=_I32) * 32 + _clz32(words),
        _BIG).to(_I32)
    suff = torch.flip(torch.cummin(torch.flip(wpos, [2]), dim=2).values, [2])
    fsa = torch.cat([suff[..., 1:], torch.full_like(suff[..., :1], _BIG)],
                    dim=-1)
    return words, fsa


def _delete_range_asc(dl, dh, lo, hi):
    """Effect of the reference's ascending Delete loop over k in [dl, dh]
    on a band [lo, hi] (wfa_wavefront.go:171-183 via wfa.go:526-535):
    (new_lo, new_hi, zero_lo, zero_hi), zeroing [zero_lo, zero_hi]."""
    nonempty = (dl <= dh) & (lo <= dh) & (hi >= dl)
    z_lo = torch.maximum(dl, lo)
    z_hi = torch.minimum(dh, hi)
    case_chain = lo >= dl
    hi_in = hi <= dh
    new_lo_a = torch.where(hi_in, hi, dh + 1)
    new_hi_a = torch.where(hi_in, hi - 1, hi)
    new_lo = torch.where(nonempty & case_chain, new_lo_a, lo)
    new_hi = torch.where(nonempty, new_hi_a, hi)
    z_lo = torch.where(nonempty, z_lo, 1)
    z_hi = torch.where(nonempty, z_hi, 0)
    return new_lo, new_hi, z_lo, z_hi


def _shift_km1(row):
    """Value at diagonal k-1: column j-1 (zero fill)."""
    return torch.cat([torch.zeros_like(row[:, :1]), row[:, :-1]], dim=1)


def _shift_kp1(row):
    """Value at diagonal k+1: column j+1 (zero fill)."""
    return torch.cat([row[:, 1:], torch.zeros_like(row[:, :1])], dim=1)


# ---------------------------------------------------------------------------
# the plain versions of kernels K1 and K4


def _plain_state(B: int, S: int, K: int, dev) -> dict:
    """The lockstep engine's state (``wfa_tpu.engine._State``): the M, I
    and D histories int32[S, B, K], the aux int32[3, S, B, K], each row's
    band bounds and existence [S, B], and per pair done, overflow,
    final_s and term_cell [B]."""
    st = {f"hist_{c}": torch.zeros((S, B, K), dtype=_I32, device=dev)
          for c in "mid"}
    st["aux"] = torch.zeros((3, S, B, K), dtype=_I32, device=dev)
    for c in "mid":
        st[f"lo_{c}"] = torch.full((S, B), _BIG, dtype=_I32, device=dev)
        st[f"hi_{c}"] = torch.full((S, B), -_BIG, dtype=_I32, device=dev)
        st[f"ex_{c}"] = torch.zeros((S, B), dtype=torch.bool, device=dev)
    for name in ("done", "overflow"):
        st[name] = torch.zeros(B, dtype=torch.bool, device=dev)
    for name in ("final_s", "term_cell"):
        st[name] = torch.zeros(B, dtype=_I32, device=dev)
    return st


def _plain_loop(st: dict, qb, tbuf, qlen, tlen, toff, *, cfg: EngineConfig,
                Lq: int, Ltb: int, s_first: int) -> None:
    """The lockstep score loop of ``wfa_tpu.engine._run_batch_impl`` over
    the state ``st`` (updated in place), scores ``s_first`` .. s_cap - 2,
    all pairs in lockstep, one score per iteration, in the fixed window of
    origin -toff and width k_win."""
    p = cfg.penalties
    x, oe, e = p.mismatch, p.gap_open + p.gap_ext, p.gap_ext
    S, K = cfg.s_cap, cfg.k_win
    reduce_on = cfg.adaptive is not None
    dev = qb.device
    B = qb.shape[0]
    k0 = -toff
    words, fsa = _stop_tables(qb, tbuf, qlen, tlen, toff, K, Lq, Ltb)
    Lw = words.shape[-1]
    iota = torch.arange(K, device=dev, dtype=_I32)[None, :]
    ks = k0[:, None] + iota
    Ak = tlen - qlen
    j_ak = (Ak - k0)[:, None]
    ql, tl, tf = qlen[:, None], tlen[:, None], toff[:, None]
    hist_m, hist_i, hist_d = st["hist_m"], st["hist_i"], st["hist_d"]
    aux_m, aux_i, aux_d = st["aux"][0], st["aux"][1], st["aux"][2]
    lo_m, lo_i, lo_d = st["lo_m"], st["lo_i"], st["lo_d"]
    hi_m, hi_i, hi_d = st["hi_m"], st["hi_i"], st["hi_d"]
    ex_m, ex_i, ex_d = st["ex_m"], st["ex_i"], st["ex_d"]
    done, overflow = st["done"], st["overflow"]
    final_s, term_cell = st["final_s"], st["term_cell"]
    zB = torch.zeros(B, dtype=_I32, device=dev)

    def krange(lo_c, hi_c, ex_c, s_cur, diff):
        """KRange with the reference's (0, 0) fallback
        (wfa_component.go:91)."""
        if diff > s_cur:
            return zB, zB
        sp = min(s_cur - diff, S - 1)
        return (torch.where(ex_c[sp], lo_c[sp], 0),
                torch.where(ex_c[sp], hi_c[sp], 0))

    def read_row(hist, lo_c, hi_c, ex_c, s_cur, diff):
        """Source row at s_cur - diff and its found mask (GetAfterDiff,
        wfa_component.go:158-167)."""
        sp = min(max(s_cur - diff, 0), S - 1)
        row = hist[sp]
        found = ((ks >= lo_c[sp][:, None]) & (ks <= hi_c[sp][:, None])
                 & (row > 0) & ex_c[sp][:, None] & (diff <= s_cur))
        return torch.where(found, row >> TYPE_BITS, 0), found

    for s in range(s_first, S - 1):
        if not bool((~(done | overflow)).any()):
            break
        lo_ms, hi_ms, ex_ms = lo_m[s].clone(), hi_m[s].clone(), ex_m[s]
        # ---------------- extend (wfa.go:381-458) ----------------
        cell = hist_m[s]
        h0 = cell >> TYPE_BITS
        v0 = h0 - ks
        act0 = ((cell > 0) & (ks >= lo_ms[:, None]) & (ks <= hi_ms[:, None])
                & ex_ms[:, None] & ~done[:, None]
                & (v0 > 0) & (v0 < ql) & (h0 < tl))
        c0 = h0 + tf
        w0 = (c0 >> 5).clamp(0, Lw - 1).long()[..., None]
        word0 = torch.gather(words, 2, w0)[..., 0]
        fsa0 = torch.gather(fsa, 2, w0)[..., 0]
        vis = ((word0.long() & 0xFFFFFFFF) << (c0 & 31).long()) & 0xFFFFFFFF
        n_ext = torch.where(vis != 0, _clz32(vis), fsa0 - c0)
        n_ext = torch.where(act0, n_ext, 0)
        row_m = torch.where(act0 & (n_ext > 0), cell + (n_ext << TYPE_BITS),
                            cell)
        hist_m[s] = row_m

        # ---------------- termination (wfa.go:235-239) ----------------
        cell_ak = torch.where(iota == j_ak, row_m, 0).sum(dim=1, dtype=_I32)
        found_ak = ex_ms & (Ak >= lo_ms) & (Ak <= hi_ms) & (cell_ak > 0)
        off_ak = torch.where(found_ak, cell_ak >> TYPE_BITS, 0)
        newly = ~done & ex_ms & (off_ak >= tlen)
        final_s = torch.where(newly, s, final_s)
        term_cell = torch.where(newly, cell_ak, term_cell)
        done = done | newly

        # ---------------- reduce (wfa.go:461-540) ----------------
        if reduce_on:
            ad = cfg.adaptive
            red = ex_ms & ~done & ((hi_ms - lo_ms + 1) >= ad.min_wf_len)
            hs = row_m >> TYPE_BITS
            vs = hs - ks
            validc = (row_m > 0) & (ks >= lo_ms[:, None]) & (ks <= hi_ms[:, None])
            okd = validc & ~((vs < 0) | (vs >= ql) | (hs >= tl))
            dist = torch.maximum(tl - hs, ql - vs)
            dmin = _masked_min(dist, okd)[:, None]
            marked = okd & ((dist - dmin) > ad.max_dist_diff)
            good = okd & ~marked
            jj = iota.expand(B, K)
            first_good = _masked_min(jj, good)[:, None]
            last_mark = _masked_max(jj, marked & (jj < first_good))
            any_marked = marked.any(dim=1)
            any_good = good.any(dim=1)
            last_good = _masked_max(jj, good)
            new_lo = torch.where(last_mark > -_BIG, k0 + last_mark + 1, lo_ms)
            new_hi = torch.where(any_marked & any_good, k0 + last_good, hi_ms)
            new_lo = torch.where(red, new_lo, lo_ms)
            new_hi = torch.where(red, new_hi, hi_ms)
            zero_m = (validc & red[:, None]
                      & ((ks < new_lo[:, None]) | (ks > new_hi[:, None])))
            row_m = torch.where(zero_m, 0, row_m)
            hist_m[s] = row_m
            aux_m[s] = torch.where(row_m != 0, aux_m[s], 0)
            lo_m[s], hi_m[s] = new_lo, new_hi

            # co-deletion from I and D (wfa.go:526-535): two ascending
            # Delete sweeps, [lo, _lo) then (_hi, hi]
            for hist_c, aux_c, lo_c, hi_c, ex_c in (
                    (hist_i, aux_i, lo_i, hi_i, ex_i),
                    (hist_d, aux_d, lo_d, hi_d, ex_d)):
                lo_cs, hi_cs = lo_c[s], hi_c[s]
                gate = red & ex_c[s]
                l1, h1, zl1, zh1 = _delete_range_asc(
                    lo_ms, new_lo - 1, lo_cs, hi_cs)
                l2, h2, zl2, zh2 = _delete_range_asc(new_hi + 1, hi_ms, l1, h1)
                zero = gate[:, None] & (
                    ((ks >= zl1[:, None]) & (ks <= zh1[:, None]))
                    | ((ks >= zl2[:, None]) & (ks <= zh2[:, None])))
                row = torch.where(zero, 0, hist_c[s])
                hist_c[s] = row
                aux_c[s] = torch.where(row != 0, aux_c[s], 0)
                lo_c[s] = torch.where(gate, l2, lo_cs)
                hi_c[s] = torch.where(gate, h2, hi_cs)

        # ---------------- next (wfa.go:549-700) ----------------
        s2 = s + 1
        lo_x, hi_x = krange(lo_m, hi_m, ex_m, s2, x)
        lo_o, hi_o = krange(lo_m, hi_m, ex_m, s2, oe)
        lo_ie, hi_ie = krange(lo_i, hi_i, ex_i, s2, e)
        lo_de, hi_de = krange(lo_d, hi_d, ex_d, s2, e)
        hi_n = torch.minimum(tlen - 1, torch.maximum(
            torch.maximum(hi_x, hi_o), torch.maximum(hi_ie, hi_de)) + 1)
        lo_n = torch.maximum(-(qlen - 1), torch.minimum(
            torch.minimum(lo_x, lo_o), torch.minimum(lo_ie, lo_de)) - 1)
        overflow = overflow | (~done & ((lo_n < k0) | (hi_n >= k0 + K)))
        live = (~done & ~overflow)[:, None]

        moe, f_moe = read_row(hist_m, lo_m, hi_m, ex_m, s2, oe)
        mx, f_mx = read_row(hist_m, lo_m, hi_m, ex_m, s2, x)
        ie, f_ie = read_row(hist_i, lo_i, hi_i, ex_i, s2, e)
        de, f_de = read_row(hist_d, lo_d, hi_d, ex_d, s2, e)

        # insertion (wfa.go:578-608): sources at k-1
        v1i, fmi = _shift_km1(moe), _shift_km1(f_moe)
        v2i, fii = _shift_km1(ie), _shift_km1(f_ie)
        # pre-invalidation snapshot: the backtrace recomputes offsets from
        # raw stored cells without the bound invalidation (wfa.go:757-827)
        isk_nb = torch.where(fmi | fii, torch.maximum(v1i, v2i) + 1, 0)
        bad = fmi & (v1i > tl)
        fmi, v1i = fmi & ~bad, torch.where(bad, 0, v1i)
        bad = fii & (v2i > tl)
        fii, v2i = fii & ~bad, torch.where(bad, 0, v2i)
        Isk = torch.maximum(v1i, v2i) + 1
        upd_i = fmi | fii
        tag_i = torch.where(fmi & (v1i >= v2i), T_INS_OPEN, T_INS_EXT).to(_I32)

        # deletion (wfa.go:612-643): sources at k+1
        v1d, fmd = _shift_kp1(moe), _shift_kp1(f_moe)
        v2d, fdd = _shift_kp1(de), _shift_kp1(f_de)
        dsk_nb = torch.where(fmd | fdd, torch.maximum(v1d, v2d), 0)
        any_id_nb = fmi | fii | fmd | fdd
        bad = fmd & ((v1d - ks) > ql)
        fmd, v1d = fmd & ~bad, torch.where(bad, 0, v1d)
        bad = fdd & ((v2d - ks) > ql)
        fdd, v2d = fdd & ~bad, torch.where(bad, 0, v2d)
        Dsk = torch.maximum(v1d, v2d)
        upd_d = fmd | fdd
        tag_d = torch.where(fmd & (v1d >= v2d), T_DEL_OPEN, T_DEL_EXT).to(_I32)

        # mismatch / M with the reference tie-breaking (wfa.go:648-698)
        v1x, fmx = mx, f_mx
        off_def_nb = torch.where(
            any_id_nb | fmx,
            torch.maximum(torch.maximum(isk_nb, dsk_nb), v1x + 1), 0)
        bad = fmx & ((v1x > tl) | ((v1x - ks) > ql))
        fmx, v1x = fmx & ~bad, torch.where(bad, 0, v1x)
        Msk = torch.maximum(torch.maximum(torch.where(upd_i, Isk, 0),
                                          torch.where(upd_d, Dsk, 0)),
                            v1x + 1)
        tag_m = torch.where(
            fmx & (Msk == v1x + 1), T_MISMATCH,
            torch.where(upd_i & (Msk == Isk), tag_i, tag_d)).to(_I32)
        band = (ks >= lo_n[:, None]) & (ks <= hi_n[:, None]) & live
        wr_i = upd_i & band
        wr_d = upd_d & band
        wr_m = (upd_i | upd_d | fmx) & band

        row_i_new = torch.where(wr_i, (Isk << TYPE_BITS) | tag_i, 0)
        row_d_new = torch.where(wr_d, (Dsk << TYPE_BITS) | tag_d, 0)
        # aux: each cell's backtrace branch is selected by its own tag
        aux_i_new = torch.where(
            wr_i, (torch.where(tag_i == T_INS_EXT, isk_nb, off_def_nb)
                   << TYPE_BITS) | tag_i, 0)
        aux_d_new = torch.where(
            wr_d, (torch.where(tag_d == T_DEL_EXT, dsk_nb, off_def_nb)
                   << TYPE_BITS) | tag_d, 0)
        aux_m_val = torch.where(
            tag_m == T_INS_EXT, isk_nb,
            torch.where(tag_m == T_DEL_EXT, dsk_nb, off_def_nb))

        # the M row merges a pre-existing wavefront at s2 (the seed row x)
        ex_m_old = ex_m[s2].clone()
        lo_m_old, hi_m_old = lo_m[s2].clone(), hi_m[s2].clone()
        row_m_old = hist_m[s2]
        row_m_new = torch.where(wr_m, (Msk << TYPE_BITS) | tag_m, row_m_old)
        aux_m_new = torch.where(wr_m, (aux_m_val << TYPE_BITS) | tag_m,
                                aux_m[s2])
        any_i, any_d, any_m = wr_i.any(1), wr_d.any(1), wr_m.any(1)
        lo_m_n = torch.minimum(_masked_min(ks, wr_m),
                               torch.where(ex_m_old, lo_m_old, _BIG))
        hi_m_n = torch.maximum(_masked_max(ks, wr_m),
                               torch.where(ex_m_old, hi_m_old, -_BIG))

        frz = done | overflow
        frzc = frz[:, None]
        hist_i[s2] = torch.where(frzc, hist_i[s2], row_i_new)
        hist_d[s2] = torch.where(frzc, hist_d[s2], row_d_new)
        hist_m[s2] = torch.where(frzc, row_m_old, row_m_new)
        aux_i[s2] = torch.where(frzc, aux_i[s2], aux_i_new)
        aux_d[s2] = torch.where(frzc, aux_d[s2], aux_d_new)
        aux_m[s2] = torch.where(frzc, aux_m[s2], aux_m_new)
        for lo_c, hi_c, ex_c, any_c, lo_n_c, hi_n_c in (
                (lo_i, hi_i, ex_i, any_i, _masked_min(ks, wr_i),
                 _masked_max(ks, wr_i)),
                (lo_d, hi_d, ex_d, any_d, _masked_min(ks, wr_d),
                 _masked_max(ks, wr_d))):
            lo_c[s2] = torch.where(frz, lo_c[s2],
                                   torch.where(any_c, lo_n_c, _BIG))
            hi_c[s2] = torch.where(frz, hi_c[s2],
                                   torch.where(any_c, hi_n_c, -_BIG))
            ex_c[s2] = torch.where(frz, ex_c[s2], any_c)
        keep_m = any_m | ex_m_old
        lo_m[s2] = torch.where(frz, lo_m_old, torch.where(keep_m, lo_m_n, _BIG))
        hi_m[s2] = torch.where(frz, hi_m_old,
                               torch.where(keep_m, hi_m_n, -_BIG))
        ex_m[s2] = torch.where(frz, ex_m_old, keep_m)

    st.update(done=done, overflow=overflow, final_s=final_s,
              term_cell=term_cell)


def run_batch_plain(qb, tbuf, qlen, tlen, toff, *, cfg: EngineConfig,
                    Lq: int, Ltb: int):
    """Plain PyTorch version of kernel K1: the score loop of
    ``wfa_tpu.engine._run_batch_impl`` (no ``w_win``/``v_win``), all pairs
    in lockstep, one score per iteration, global or semi-global.

    Returns (final_s int32[B], done bool[B], overflow bool[B],
    term_cell int32[B], aux int32[3, S, B, K], end) where ``term_cell`` is
    the raw M cell at (final_s, Ak), ``aux`` is the backtrace aux
    (``offset0 << 3 | tag`` per cell; components M, I, D) and ``end`` is
    the backtrace start (end_s, end_k, end_cell), int32[B] each: global
    (final_s, Ak, term_cell); semi-global the end finder's pick over the
    stored M history (``device_backtrace.end_finder_plain``) and its raw
    cell, as ``wfa_tpu.engine._align_full_impl`` takes it, for pairs done
    and not overflowed, else the global triple.

    ``cfg.prefix`` (phase 1 of the two-phase semi-global route,
    ``wfa_tpu.engine.EngineConfig.prefix``) runs scores 0 .. s_cap - 2,
    keeps still-running pairs out of overflow and returns the lockstep
    state itself (:func:`_plain_state`'s dict, rows 0 .. s_cap - 1)."""
    qlen, tlen, toff = qlen.to(_I32), tlen.to(_I32), toff.to(_I32)
    st = _plain_run(qb, tbuf, qlen, tlen, toff, cfg=cfg, Lq=Lq, Ltb=Ltb)
    if cfg.prefix:  # still-running pairs continue in phase 2
        return st
    final_s, done, term_cell = st["final_s"], st["done"], st["term_cell"]
    overflow = st["overflow"] | ~done
    k0 = -toff
    Ak = tlen - qlen
    end = (final_s, Ak, term_cell)
    if not cfg.global_alignment:
        end = _semi_end(st["hist_m"], k0, final_s, qlen, tlen, done,
                        overflow, term_cell, cfg.s_cap, cfg.k_win)
    return final_s, done, overflow, term_cell, st["aux"], end


def _plain_run(qb, tbuf, qlen, tlen, toff, *, cfg: EngineConfig, Lq: int,
               Ltb: int) -> dict:
    """Seed and run the lockstep loop from score 0 (int32 lengths);
    returns the state of :func:`_plain_state` after it."""
    x = cfg.penalties.mismatch
    S, K = cfg.s_cap, cfg.k_win
    B = qb.shape[0]
    k0 = -toff
    Ak = tlen - qlen
    st = _plain_state(B, S, K, qb.device)
    # the window must hold the seed diagonals and the terminal one
    overflow = (Ak < k0) | (Ak >= k0 + K) | (0 < k0) | (0 >= k0 + K)
    if not cfg.global_alignment:
        overflow = overflow | ((tlen - 1) >= k0 + K)
    (row0, lo0, hi0, ex0), (rowx, lox, hix, exx) = _seed_rows(
        qb, tbuf, qlen, tlen, toff, mismatch=x, K=K, Ltb=Ltb,
        global_alignment=cfg.global_alignment)
    hist_m, aux_m = st["hist_m"], st["aux"][0]
    hist_m[0], aux_m[0] = row0, row0 & 7  # seeds have no sources
    st["lo_m"][0], st["hi_m"][0], st["ex_m"][0] = lo0, hi0, ex0
    if 0 < x < S:
        hist_m[x], aux_m[x] = rowx, rowx & 7
        st["lo_m"][x], st["hi_m"][x], st["ex_m"][x] = lox, hix, exx
    elif x >= S:
        overflow = overflow | exx
    st["overflow"] = overflow
    _plain_loop(st, qb, tbuf, qlen, tlen, toff, cfg=cfg, Lq=Lq, Ltb=Ltb,
                s_first=0)
    return st


def _semi_end(hist_m, k0, final_s, qlen, tlen, done, overflow, term_cell,
              S: int, K: int, found_before=None):
    """The backtrace start of semi-global pairs: the end finder's pick over
    the M history rows <= final_s and its raw cell (GetRaw, wfa.go:738),
    for pairs done and not overflowed; (final_s, Ak, term_cell) otherwise
    and where nothing was found.  ``found_before`` ((found, end_s, end_k,
    end_cell), the phase-1 pick of the two-phase route) wins where found."""
    from .device_backtrace import end_finder_plain

    B = final_s.shape[0]
    Ak = tlen - qlen
    end_s, end_k, found = end_finder_plain(hist_m, k0, final_s, qlen, tlen,
                                           S, K)
    j = (end_k - k0).clamp(0, K - 1).long()
    end_cell = hist_m[end_s.clamp(0, S - 1).long(),
                      torch.arange(B, device=hist_m.device), j]
    if found_before is not None:
        f1, s1, k1, c1 = found_before
        found = found | f1
        end_s = torch.where(f1, s1, end_s)
        end_k = torch.where(f1, k1, end_k)
        end_cell = torch.where(f1, c1, end_cell)
    ok = done & ~overflow & found
    return (torch.where(ok, end_s, final_s), torch.where(ok, end_k, Ak),
            torch.where(ok, end_cell, term_cell))


def windows(penalties) -> Tuple[int, int]:
    """(WM, WE): the circular window rows of M (max(x, o+e) + 1) and of
    I and D (e + 1)."""
    p = penalties
    return max(p.mismatch, p.gap_open + p.gap_ext) + 1, p.gap_ext + 1


def semi_cell16(Ltb: int) -> bool:
    """Whether a semi-global aux cell (offset0 <= tlen + 1) fits int16
    for a target buffer of Ltb columns (wfa_tpu/semi2.py:244,
    pallas_engine.py:1490-1493)."""
    return Ltb + 2 <= 4095


def run_batch_resume_plain(qb, tbuf2, qlen, tlen, toff2, win_m, win_i,
                           win_d, ainit, b_m, b_ie, meta1, *,
                           cfg: EngineConfig, Lq: int, Ltb2: int,
                           Ltb_full: int, S0: int):
    """Plain PyTorch version of kernel K4, the narrow resume of the
    two-phase semi-global route (``wfa_tpu.pallas_engine
    .pallas_run_resume``): the lockstep loop of :func:`run_batch_plain`
    started at score ``S0`` from the phase-1 handoff
    (``semi2.prefix_export``) in the narrow window of origin
    k02 = -toff2 and width k_win, scores S0 .. s_cap - 2.

    ``tbuf2`` holds each target re-placed for its window (column c is
    target position c - toff2; toff2 < 0 means the row holds the target's
    suffix from k02 on).  The slot-ordered exports fill the window rows
    (slot r of a W-row window is the score in (S0 - W, S0] congruent to r
    mod W) and their band rows, ``ainit`` the aux row S0; ``meta1`` gives
    done, final_s, term_cell, the phase-1 end finder's state and the
    pairs that escape (overflow2).  Pairs done or escaped at S0 do not
    run.  The end finder goes on from score S0 where phase 1 found
    nothing.

    Returns (final_s, done, overflow, term_cell, aux2, (end_s, end_k,
    end_cell)), :func:`run_batch_plain`'s contract with aux2
    [3, s_cap - S0, B, K] holding scores S0 .. s_cap - 1, int16 cells when
    ``semi_cell16(Ltb_full)`` (offsets are target positions, so the full
    buffer decides, not Ltb2)."""
    from .semi2 import (M1_DONE, M1_ECELL, M1_EFOUND, M1_EK, M1_ES, M1_FS,
                        M1_OVF, M1_TERM)

    WM, WE = windows(cfg.penalties)
    S, K = cfg.s_cap, cfg.k_win
    B = qb.shape[0]
    qlen, tlen, toff2 = qlen.to(_I32), tlen.to(_I32), toff2.to(_I32)
    k0 = -toff2
    Ak = tlen - qlen
    m1 = meta1.to(_I32)
    st = _plain_state(B, S, K, qb.device)
    done = m1[:, M1_DONE] > 0
    overflow = (m1[:, M1_OVF] > 0) | (Ak < k0) | (Ak >= k0 + K)
    # pairs that do not run import nothing, so nothing of theirs moves
    run = (~done & ~overflow)[:, None]
    for c, win, bands, base, W in (("m", win_m, b_m, 0, WM),
                                   ("i", win_i, b_ie, 0, WE),
                                   ("d", win_d, b_ie, 3 * WE, WE)):
        for r in range(W):
            srow = S0 - ((S0 - r) % W)
            st[f"hist_{c}"][srow] = torch.where(run, win[r], 0)
            st[f"lo_{c}"][srow] = bands[base + r]
            st[f"hi_{c}"][srow] = bands[base + W + r]
            st[f"ex_{c}"][srow] = (bands[base + 2 * W + r] > 0) & run[:, 0]
    st["aux"][:, S0] = torch.where(run, ainit, 0)
    st.update(done=done, overflow=overflow, final_s=m1[:, M1_FS].clone(),
              term_cell=m1[:, M1_TERM].clone())
    _plain_loop(st, qb, tbuf2, qlen, tlen, toff2, cfg=cfg, Lq=Lq, Ltb=Ltb2,
                s_first=S0)
    final_s, done, term_cell = st["final_s"], st["done"], st["term_cell"]
    overflow = st["overflow"] | ~done
    hist_m = st["hist_m"]
    hist_m[:S0] = 0  # phase 1 searched the rows below S0
    end = _semi_end(hist_m, k0, final_s, qlen, tlen, done, overflow,
                    term_cell, S, K,
                    found_before=(m1[:, M1_EFOUND] > 0, m1[:, M1_ES],
                                  m1[:, M1_EK], m1[:, M1_ECELL]))
    aux2 = st["aux"][:, S0:]
    aux2 = aux2.to(torch.int16 if semi_cell16(Ltb_full) else _I32)
    return final_s, done, overflow, term_cell, aux2, end


def rebase_aux(aux):
    """Value-rebase an int32 aux tensor [3, S, B, K] per (score, pair)
    row, as the long-read TPU kernel streams it
    (wfa_tpu/pallas_longread.py:754-791): the row's base is the minimum
    offset0 over the three planes' nonzero cells (0 for an empty row), and
    each nonzero cell becomes ((offset0 - base + 1) << 3 | tag), so a
    stored 0 still means absent.  Returns (aux int16[3, S, B, K],
    aux_base int32[B, S], wide bool[S, B]): ``wide`` marks rows with a
    rebased value above :data:`MAX_REBASED`, whose int16 cells wrapped.
    One plane at a time, so the temporaries stay a third of ``aux``."""
    base = torch.full(aux.shape[1:3], _BIG, dtype=_I32, device=aux.device)
    for plane in aux:
        base = torch.minimum(base, torch.where(
            plane > 0, plane >> TYPE_BITS, _BIG).amin(dim=2))  # [S, B]
    base = torch.where(base >= _BIG, 0, base)
    out = torch.empty(aux.shape, dtype=torch.int16, device=aux.device)
    wide = torch.zeros(aux.shape[1:3], dtype=torch.bool, device=aux.device)
    for plane, dst in zip(aux, out):
        nz = plane > 0
        v = (plane >> TYPE_BITS) - base[:, :, None] + 1
        wide |= (nz & (v > MAX_REBASED)).any(dim=2)
        dst.copy_(torch.where(nz, (v << TYPE_BITS) | (plane & 7), 0))
    return out, base.t().contiguous(), wide


def run_batch_long_plain(qb, tbuf, qlen, tlen, toff, *, cfg: EngineConfig,
                         Lq: int, Ltb: int):
    """Plain PyTorch version of K1-long (``kernel_engine.run_batch_long``),
    the port of ``wfa_tpu.pallas_longread.pallas_run_batch``: the score
    loop of :func:`run_batch_plain` (global alignment), its aux rebased by
    :func:`rebase_aux`.

    Returns (final_s int32[B], done bool[B], overflow bool[B],
    term_cell int32[B], aux int16[3, S, B, K], aux_base int32[B, S]), the
    JAX layout without its block padding.  A done pair with a row
    <= final_s too wide for int16 cells is reported overflowed instead
    (done 0, final_s and term_cell 0), as K1-long reports it."""
    if not cfg.global_alignment:
        raise ValueError("the long-read score loop is global only")
    final_s, done, overflow, term_cell, aux, _ = run_batch_plain(
        qb, tbuf, qlen, tlen, toff, cfg=cfg, Lq=Lq, Ltb=Ltb)
    aux16, aux_base, wide = rebase_aux(aux)
    del aux
    rows = torch.arange(cfg.s_cap, device=qb.device)[:, None]
    bad = (done & ~overflow
           & (wide & (rows <= final_s[None, :])).any(dim=0))
    return (torch.where(bad, 0, final_s), done & ~bad, overflow | bad,
            torch.where(bad, 0, term_cell), aux16, aux_base)


def rebase_aux_kw(st: dict, k0, KW: int):
    """Row- and value-rebase the lockstep aux ``st["aux"]`` int32[3, S, B,
    K] as the TPU kernel's KW mode streams it
    (wfa_tpu/pallas_engine.py:784-837).  Per (score, pair) row: the row
    base ``cb`` is the first column of the post-reduce M/I/D band union
    (``st``'s lo/hi/ex rows, where each exists) // 32, clipped to [0,
    (K - KW) // 32], and 0 for a row with no band; the value base ``vb`` is
    the minimum offset0 over the three planes' nonzero cells, 0 for an
    empty row and never below 0.  The row keeps columns [cb * 32, cb * 32 +
    KW), each nonzero cell as ((offset0 - vb + 1) << 3 | tag).

    Returns (aux int16[3, S, B, KW], sbase int32[S, B] = vb << 5 | cb,
    escape bool[S, B]): ``escape`` marks rows with a band whose top passes
    the window or whose offsets spread past :data:`MAX_REBASED` (their
    int16 cells wrapped).  A chunk of score rows at a time keeps the
    temporaries small."""
    aux = st["aux"]
    _, S, B, K = aux.shape
    dev = aux.device
    k0 = k0.to(_I32)[None, :]
    lo_u = torch.full((S, B), _BIG, dtype=_I32, device=dev)
    hi_u = torch.full((S, B), -_BIG, dtype=_I32, device=dev)
    anyb = torch.zeros((S, B), dtype=torch.bool, device=dev)
    for c in "mid":
        ex = st[f"ex_{c}"]
        lo_u = torch.where(ex, torch.minimum(lo_u, st[f"lo_{c}"]), lo_u)
        hi_u = torch.where(ex, torch.maximum(hi_u, st[f"hi_{c}"]), hi_u)
        anyb = anyb | ex
    # lax.div truncates toward zero
    cb = torch.div(lo_u - k0, 32, rounding_mode="trunc").clamp(
        0, (K - KW) // 32)
    cb = torch.where(anyb, cb, 0).to(_I32)
    step = max(1, (1 << 26) // max(1, B * K))
    vb = torch.full((S, B), _BIG, dtype=_I32, device=dev)
    vmx = torch.full((S, B), -_BIG, dtype=_I32, device=dev)
    for plane in aux:
        for r in range(0, S, step):
            a = plane[r:r + step]
            nz = a > 0
            v = a >> TYPE_BITS
            vb[r:r + step] = torch.minimum(
                vb[r:r + step], torch.where(nz, v, _BIG).amin(dim=2))
            vmx[r:r + step] = torch.maximum(
                vmx[r:r + step], torch.where(nz, v, -_BIG).amax(dim=2))
    vb = torch.where(vb >= _BIG, 0, vb).clamp(min=0)
    escape = anyb & (((hi_u - k0 - cb * 32) >= KW)
                     | ((vmx - vb + 1) > MAX_REBASED))
    out = torch.empty((3, S, B, KW), dtype=torch.int16, device=dev)
    cols = torch.arange(KW, device=dev)
    for plane, dst in zip(aux, out):
        for r in range(0, S, step):
            idx = (cb[r:r + step, :, None] * 32).long() + cols
            win = torch.gather(plane[r:r + step], 2, idx)
            v = (win >> TYPE_BITS) - vb[r:r + step, :, None] + 1
            dst[r:r + step] = torch.where(win > 0, (v << TYPE_BITS) | (win & 7),
                                          0).to(torch.int16)
    return out, (vb << 5) | cb, escape


def run_batch_kw_plain(qb, tbuf, qlen, tlen, toff, *, cfg: EngineConfig,
                       Lq: int, Ltb: int):
    """Plain PyTorch version of K1-kw (``kernel_engine.run_batch_kw``), the
    port of ``wfa_tpu.pallas_engine.pallas_run_batch`` with
    ``cfg.aux_kw``: the score loop of :func:`run_batch_plain` (global
    alignment), its aux rebased by :func:`rebase_aux_kw`.

    Returns (final_s int32[B], done bool[B], overflow bool[B],
    term_cell int32[B], aux int16[3, S, B, KW], sbase int32[S, B]), the
    JAX layout without its block padding (JAX's aux is [3, S, KW, Bp]).
    The TPU kernel tests a row's escape where it writes the row, after
    the termination test, and stops the pair there: a pair with an
    escaping row below final_s ends not done (final_s and term_cell 0), a
    pair that terminates on an escaping row ends done and overflowed, its
    final_s and term_cell kept.  Rows above final_s, and every row of a
    pair not served, are unspecified (:func:`canonical_kw`)."""
    KW = check_aux_kw(cfg, Ltb)
    qlen, tlen, toff = qlen.to(_I32), tlen.to(_I32), toff.to(_I32)
    st = _plain_run(qb, tbuf, qlen, tlen, toff, cfg=cfg, Lq=Lq, Ltb=Ltb)
    for c in "mid":  # only the aux and the band rows are read below
        del st[f"hist_{c}"]
    aux16, sbase, escape = rebase_aux_kw(st, -toff, KW)
    del st["aux"]
    final_s, done, term_cell = st["final_s"], st["done"], st["term_cell"]
    overflow = st["overflow"] | ~done
    rows = torch.arange(cfg.s_cap, device=qb.device)[:, None]
    escape = escape & (rows <= final_s[None, :]) & (done & ~overflow)[None, :]
    first = torch.where(escape, rows, _BIG).amin(dim=0)  # [B]
    early = first < final_s
    return (torch.where(early, 0, final_s), done & ~early,
            overflow | (first < _BIG), torch.where(early, 0, term_cell),
            aux16, sbase)


def canonical_kw(res):
    """K1-kw's results (:func:`run_batch_kw_plain`'s tuple) with the aux
    rows and sbase words it leaves unspecified zeroed: every row of a pair
    not served, and rows above final_s of those served."""
    final_s, done, overflow, term_cell, aux, sbase = res
    rows = torch.arange(aux.shape[1], device=aux.device)[:, None]
    keep = (done & ~overflow)[None, :] & (rows <= final_s[None, :])
    return (final_s, done, overflow, term_cell,
            torch.where(keep[None, :, :, None], aux, 0),
            torch.where(keep, sbase, 0))


# ---------------------------------------------------------------------------
# backtrace, compaction and the byte stream the host decodes


def _finish_outputs(aux, start_cell, k0, start_s, start_k, qlen, tlen, done,
                    overflow, *, cfg: EngineConfig, Lq: int, Ltb: int,
                    edit: bool, aux_base=None, aux_old=None, k0_old=None,
                    s_split: int = 0, aux_sbase=None, stride: int = 1):
    """Backtrace (kernel K2), token compaction and the meta header, equal
    to ``wfa_tpu.engine._finish_outputs`` on its flat branch.  A score loop
    run at ``stride`` (:func:`score_stride`) hands over its aux in rows of
    ``loop_config(cfg, stride)`` and ``start_s`` in those rows: K2 walks
    them at that config, the meta's scores are ``start_s * stride``, and
    the output layout follows ``cfg``.  ``aux_base``
    marks the long-read score loop's value-rebased int16 aux, ``aux_sbase``
    K1-kw's row- and value-rebased aux, KW = ``cfg.aux_kw`` columns wide
    (wfa_tpu/engine.py:1315-1317).  The
    two-phase semi-global route (``semi2.phase2``) passes phase 2's aux
    (scores s_split .. s_cap - 1) as ``aux`` and phase 1's full-span aux
    (scores below s_split, window origin ``k0_old``) as ``aux_old``
    (wfa_tpu/engine.py:1301-1332).

    When ``_token_plan`` calls the stream compact: ``{"mtb": uint8,
    "lg": int16/int32}``, byte-identical to JAX's ``compact and flat``
    branch, edit-only when ``edit``, else full.  Otherwise the raw
    ``{"meta", "tok0", "buf", "tail"}`` (engine.py:1386-1388): a full
    stream, never edit-only (engine.py:1324), whose meta trim column is
    the chase's iteration count; :func:`assemble_raw` joins it on the
    host."""
    from .device_backtrace import (compact_tokens_flat_u8, device_backtrace,
                                   iter_capacity)

    S = cfg.s_cap
    K = cfg.aux_kw if aux_sbase is not None else cfg.k_win
    token_shift, compact = _token_plan(S, cfg.penalties, Lq, Ltb)
    edit = edit and compact  # the raw layout is never edit-only
    lcfg = loop_config(cfg, stride)
    it_cap = iter_capacity(S, cfg.penalties)
    bt = device_backtrace(
        aux, start_cell, k0, start_s, start_k, qlen, tlen, done & ~overflow,
        penalties=lcfg.penalties, S=lcfg.s_cap, K=K, token_shift=token_shift,
        split_ext_codes=edit, global_alignment=cfg.global_alignment,
        aux_base=aux_base, aux_old=aux_old, k0_old=k0_old, s_split=s_split,
        aux_sbase=aux_sbase, return_iters=not compact, it_cap=it_cap)
    tok0, buf, tail = bt[:3]
    start_s = start_s * stride
    ns_cap = 2 * it_cap + 5
    meta16 = max(Lq + Ltb, S, ns_cap) <= 32000
    if not compact:
        iters = bt[3]
        # the JAX loop's trip count: the most iterations any pair ran
        it_used = (iters.amax() if iters.numel()
                   else torch.zeros((), dtype=_I32, device=iters.device))
        zeros = torch.zeros_like(start_s, dtype=_I32)
        meta = torch.stack([start_s.to(_I32), overflow.to(_I32),
                            zeros + it_used, zeros], dim=1)
        return {"meta": meta.to(torch.int16) if meta16 else meta,
                "tok0": tok0, "buf": buf, "tail": tail}
    # an edit-only stream drops the match runs; the host rebuilds them
    bytes_flat, longs_flat, n_tok, n_long = compact_tokens_flat_u8(
        tok0, buf, tail, token_shift, drop_m=edit)
    meta = torch.stack([start_s.to(_I32), overflow.to(_I32), n_tok, n_long],
                       dim=1)
    mb = 2 if meta16 else 4
    # little-endian bytes of each column; a logical shift, so widen first
    # (torch's >> on int32 is arithmetic)
    m64 = meta.long() & 0xFFFFFFFF
    meta_bytes = torch.stack([(m64 >> (8 * i)) & 255 for i in range(mb)],
                             dim=2).reshape(-1).to(torch.uint8)
    return {"mtb": torch.cat([meta_bytes, bytes_flat]), "lg": longs_flat}


def align_full2(seq, lens, *, cfg: EngineConfig, B: int, Lq: int, Ltb: int,
                packed: bool = False, edit: Optional[bool] = None,
                engine: str = "auto"):
    """Full alignment of an uploaded batch, the port of
    ``wfa_tpu.engine._align_full2``, flat: ``seq`` is the query
    and target byte matrices side by side (2-bit packed when ``packed``),
    ``lens`` is int32[B, 3] (qlen, tlen, toff).  Score loop -> backtrace
    (K2) from the end the score loop reports -> compaction; returns
    :func:`_finish_outputs`' dict, plus ``"final_s"`` (int32[B]) in
    semi-global mode: the score at which each pair reached its global end,
    where K1 stops, which lies above its semi-global score.  ``edit``
    picks the token stream (default :func:`edit_only`).

    ``engine`` "auto" runs K1; "long" runs K1-long (global only, JAX's
    ``engine="pallas_long"``, engine.py:1247-1266) and K2 over its
    rebased aux from (final_s, Ak, term_cell); "kw" runs K1-kw (global
    only, ``cfg.aux_kw`` columns, JAX's ``engine="pallas"`` with
    ``aux_kw``, engine.py:1232-1246) and K2 over its rebased aux through
    the sbase words, from (final_s, Ak, term_cell).

    A global score loop and K2 run at ``loop_config(cfg, g)``, g =
    :func:`score_stride`: only the rows that can hold a cell, the same
    cells in the same order, so every output byte is the stride-1 loop's."""
    from .kernel_engine import run_batch, run_batch_kw, run_batch_long

    qw = Lq // 4 if packed else Lq
    qb, tbuf = seq[:, :qw], seq[:, qw:]
    qlen, tlen, toff = (lens[:, i].contiguous() for i in range(3))
    if packed:
        qb = _unpack2(qb, Lq, torch.zeros_like(qlen), qlen)
        tbuf = _unpack2(tbuf, Ltb, toff, toff + tlen)
    args = (qb.contiguous(), tbuf.contiguous(), qlen, tlen, toff)
    edit = edit_only(cfg) if edit is None else edit
    g = score_stride(cfg)
    lcfg = loop_config(cfg, g)
    if engine == "long":
        final_s, done, overflow, term_cell, aux, aux_base = run_batch_long(
            *args, cfg=lcfg, Lq=Lq, Ltb=Ltb)
        return _finish_outputs(aux, term_cell, -toff, final_s, tlen - qlen,
                               qlen, tlen, done, overflow, cfg=cfg, Lq=Lq,
                               Ltb=Ltb, edit=edit, aux_base=aux_base,
                               stride=g)
    if engine == "kw":
        final_s, done, overflow, term_cell, aux, sbase = run_batch_kw(
            *args, cfg=lcfg, Lq=Lq, Ltb=Ltb)
        return _finish_outputs(aux, term_cell, -toff, final_s, tlen - qlen,
                               qlen, tlen, done, overflow, cfg=cfg, Lq=Lq,
                               Ltb=Ltb, edit=edit, aux_sbase=sbase,
                               stride=g)
    final_s, done, overflow, _, aux, (end_s, end_k, end_cell) = run_batch(
        *args, cfg=lcfg, Lq=Lq, Ltb=Ltb)
    out = _finish_outputs(aux, end_cell, -toff, end_s, end_k, qlen, tlen,
                          done, overflow, cfg=cfg, Lq=Lq, Ltb=Ltb, edit=edit,
                          stride=g)
    if not cfg.global_alignment:
        out["final_s"] = final_s
    return out


def _meta_from_bytes(head: np.ndarray, B: int) -> np.ndarray:
    """meta int32[B, 4] from the little-endian meta bytes that lead an
    ``"mtb"`` stream."""
    nm = len(META_COLS)
    mb = head.shape[0] // (nm * B)
    mraw = head.reshape(B, nm, mb).astype(np.int64)
    return sum(mraw[:, :, i] << (8 * i) for i in range(mb)).astype(np.int32)


def _split_tokens(meta: np.ndarray, b: np.ndarray, longs: np.ndarray):
    """Per-pair token arrays from the byte stream ``b`` and the long
    stream ``longs`` (each at least as long as the pairs' totals in
    ``meta``): byte = code << 5 | run, and each placeholder byte (224)
    takes the long stream's next token."""
    ends = np.cumsum(meta[:, M_TRIM].astype(np.int64))
    ends_l = np.cumsum(meta[:, M_LONG].astype(np.int64))
    b = b[:int(ends[-1])]
    longs = longs[:int(ends_l[-1])]
    shift = 12 if longs.dtype == np.int16 else 28
    toks = (((b >> 5).astype(np.int32) << shift) | (b & 31)).astype(
        longs.dtype)
    toks[b == 224] = longs
    el = ends.tolist()
    return [toks[a:z] for a, z in zip([0] + el[:-1], el)]


def decode_outputs(pairs, mtb: np.ndarray, lg: np.ndarray):
    """Split a fetched ``{"mtb", "lg"}`` pair of streams into (meta
    int32[B, 4], per-pair token arrays), as
    ``wfa_tpu.engine.BatchAligner.finish_small/finish_tokens`` do."""
    hd = mtb.shape[0] - lg.shape[0]
    meta = _meta_from_bytes(mtb[:hd], len(pairs))
    return meta, _split_tokens(meta, mtb[hd:], lg)


def assemble_raw(pairs, out) -> tuple:
    """(meta int32[B, 4], per-pair token rows) of a fetched raw output
    ``{"meta", "tok0", "buf", "tail"}`` (numpy arrays; ``buf`` may stop
    after the rows the chase used): each row is tok0, buf[0], buf[1], ...,
    tail with zeros for empty slots, as
    ``wfa_tpu.engine.BatchAligner._finish`` joins it (engine.py:2114-2125).
    """
    tok0, buf, tail = out["tok0"], out["buf"], out["tail"]
    B = tok0.shape[0]
    toks = np.concatenate(
        [tok0[:, None], np.transpose(buf, (1, 0, 2)).reshape(B, -1), tail],
        axis=1)
    return out["meta"].astype(np.int32), list(toks[:len(pairs)])


def _coarse(n: int, lo: int = 512) -> int:
    """Round a guessed fetch extent up to a grid of at least 1/8 of its
    magnitude (``wfa_tpu.engine._coarse``), so that the pinned buffers
    of the speculative fetch come in few sizes."""
    g = lo
    while g * 8 < n:
        g *= 2
    return ((n + g - 1) // g) * g


class DeviceResult(AlignmentResult):
    """An :class:`AlignmentResult` made from a pair's token stream,
    decoded lazily on first access (:meth:`AlignmentResult.process`:
    an edit-only stream ``(toks, q, t)`` or a full one).

    ``final_s`` (set by :meth:`BatchAligner.finish_batch`) is the score at
    which K1 stopped the pair: its score in global mode, the cost of its
    global end in semi-global mode.  A score cap must lie above it.

    A semi-global result also carries its pair's lengths (``lens``, set
    there too) and takes its coordinates from the end, as the oracle's
    bookkeeping does: on rare pairs the oracle's leading ops stop one
    base off (the stop at row or column 1, backtrace.py), so its CIGAR
    does not use up both lengths and a walk from (0, 0) lands one
    diagonal off the oracle's coordinates; a walk back from
    (len q, len t) does not.  A global CIGAR uses up both lengths, so
    there both walks agree."""

    __slots__ = ("final_s", "lens")

    def _derive_from_ops(self) -> None:
        super()._derive_from_ops()
        if self.global_alignment or not self._q_end:
            return
        # the forward walk's coordinates, shifted by the bases the ops
        # leave unused: those of the walk back from (len q, len t)
        dq = self.lens[0] - sum(n for op, n in self._ops if op != "I")
        dt = self.lens[1] - sum(n for op, n in self._ops if op in "MXI")
        self._q_begin += dq
        self._q_end += dq
        self._t_begin += dt
        self._t_end += dt


@dataclasses.dataclass(eq=False)
class Submitted:
    """A submitted batch (:meth:`BatchAligner.submit_batch`): its pairs,
    its outputs on the device (``out``, released by
    :meth:`BatchAligner.finish_tokens`), whether its token stream is
    edit-only, and its fetch: ``host``, the host copies queued so far by
    output name ("mtb" the meta bytes and the guessed token extent, "lg"
    the long stream's guess, "buf" the raw layout's, "*_rest" what
    :meth:`BatchAligner.finish_small` found the guess missed, ``missed``
    then true; pinned buffers on the card, the tensors themselves on the
    CPU), ``ran``, the event after the batch's last launch, ``copied``,
    the event after its last queued copy (both None on the CPU), and the
    meta that ``finish_small`` read.  A mesh's batch holds its shards' handles
    (``parts``)."""
    pairs: list
    out: dict
    edit: bool
    host: dict = dataclasses.field(default_factory=dict)
    ran: Optional[torch.cuda.Event] = None
    copied: Optional[torch.cuda.Event] = None
    meta: Optional[np.ndarray] = None
    # a mesh's batch: (aligner, handle) of each shard, in batch order
    parts: Optional[list] = None
    # a shard fetched and gathered from another process: (meta, token
    # rows, edit-only, final_s), what finish_tokens builds results from
    tokens: Optional[tuple] = None
    # the guessed token extent fell short: finish_small queued the rest
    missed: bool = False

    @property
    def nbytes(self) -> int:
        """Device bytes the batch's outputs hold until its finish."""
        if self.parts is not None:
            return sum(p.nbytes for _, p in self.parts)
        return sum(a.numel() * a.element_size() for a in self.out.values())


def _joined(left: np.ndarray, right: np.ndarray):
    """The one C-contiguous matrix whose columns are ``left`` then
    ``right`` (as :func:`_pack_all`'s direct pack writes them), or None
    where the two are not its halves."""
    m = left.base
    if (m is None or m is not right.base or not m.flags.c_contiguous
            or m.shape != (left.shape[0], left.shape[1] + right.shape[1])):
        return None
    at = m.ctypes.data
    if left.ctypes.data != at or right.ctypes.data != at + left.shape[1]:
        return None
    return m


def _seq_lens(packed_batch):
    """(seq, lens, packed, Lq, Ltb) of a :func:`_pack_all` tuple:
    the query and target rows side by side (2-bit packed where the pack
    gave them; the direct pack's one matrix as it is) and the (qlen,
    tlen, toff) columns, as ``align_full2`` takes them."""
    qb, tbuf, qlen, tlen, toff, Lq, Ltb, qp, tp = packed_batch
    packed = tp is not None
    seq = _joined(qp, tp) if packed else None
    if seq is None:
        seq = np.concatenate([qp if packed else qb, tp if packed else tbuf],
                             axis=1)
    lens = np.stack([qlen, tlen, toff], axis=1).astype(np.int32)
    return seq, lens, packed, Lq, Ltb


class BatchAligner:
    """Batched aligner on one device: pack -> K1 (K1-long, K1-kw) -> K2 ->
    decode.

    Pairs whose band or score leaves the configured windows (or, on
    K1-long and K1-kw, whose aux rows do not fit their int16 cells or KW
    columns) are aligned by the exact host oracle (``fallback=True``) or
    returned as None, so a pipeline can retry them with larger caps.
    ``engine`` "auto" runs K1, "long" K1-long (global alignment only; the
    JAX package's ``"pallas_long"``), "auto:kw<KW>" or "pallas:kw<KW>"
    K1-kw with ``aux_kw = min(KW, k_win)`` (global alignment only, as
    ``wfa_tpu.engine.BatchAligner`` parses them on its kernel path),
    "semi2:<S0>" the two-phase semi-global route
    (:mod:`wfa_tpu_torch.semi2`: K3 at the full span to score S0, then K4
    in a ``k_win``-wide window, then K2 over both aux tensors).  The card
    is the default device; ``device="cpu"`` runs the plain versions.

    The fetch is split as ``wfa_tpu.engine.BatchAligner``'s: a submit
    queues the copies of the small outputs and of the token streams at a
    guessed extent (the last batches' used extent and 1/8 more) right
    after its launches; :meth:`finish_small` reads the meta and queues
    what the guess missed; :meth:`finish_tokens` builds the results.  On
    the card a submit runs with this aligner's card as the thread's
    current device, the launches on that device's current stream and the
    copies on a copy stream of this aligner that waits for them, into
    pinned buffers, and the uploads on the card's upload stream
    (:func:`upload`); so a submit waits neither for its own launches nor
    for earlier batches' (but the
    two-phase route's mid-point fetch of ``meta1``), and several threads
    may submit and finish batches of one aligner at once.

    ``mesh`` (:func:`wfa_tpu_torch.parallel.make_dp_mesh`, kept when its
    size passes 1; ``device`` is then its first device) shards each batch
    over its devices and processes: the batch is padded to a multiple of
    the mesh size with ``(b"A", b"A")`` pairs whose results are dropped,
    packed whole, and each shard runs what one card's batch runs, on its
    rows and its device, and ships the same outputs, fetched by an aligner
    of that device, as above (:meth:`submit_batch`).  Across processes a
    submit also waits for its shards, fetches them and gathers every
    process's (``DpMesh.exchange``), so that every process returns every
    result.
    """

    def __init__(self, penalties: Penalties = Penalties(),
                 options: Options = Options(),
                 adaptive: Optional[AdaptiveReductionOption] = None,
                 k_win: int = 128, s_cap: int = 256, device="cuda",
                 engine: str = "auto", mesh=None) -> None:
        if adaptive is not None and adaptive.min_wf_len == 0:
            # constructor-path twin of the attach check (wfa.go:134-137)
            raise ValueError("cutoff step should not be 0")
        self.s_switch = 0
        engine_arg = engine
        kw = engine_kw(engine, k_win)
        if kw is not None:
            engine = "kw"
        elif engine.startswith("semi2:"):
            # "semi2:<S0>" carries the score phase 2 resumes at
            # (wfa_tpu/engine.py:1456-1461)
            self.s_switch = int(engine.split(":", 1)[1])
            engine = "semi2"
            if options.global_alignment:
                raise ValueError("the two-phase route is semi-global only")
        elif engine not in ("auto", "long"):
            raise ValueError(f"unknown engine {engine!r}")
        self.cfg = EngineConfig(penalties=penalties,
                                global_alignment=options.global_alignment,
                                adaptive=adaptive, k_win=k_win, s_cap=s_cap,
                                aux_kw=kw)
        self.engine = engine
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None:
            device = self.mesh.devices[0]
        self.device = resolve_device(device)
        self._copy = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        self._oracle = OracleAligner(penalties, options, adaptive)
        # full spans phase 1 ran at ("semi2")
        self.spans = set()
        # speculative fetch extents by output ("mtb" token bytes, "lg"
        # long tokens, "buf" raw rows); None until a batch calibrates them
        self._tok_guess = {"mtb": None, "lg": None, "buf": None}
        # the aligner that fetches the shards of each mesh device
        self._shard_aligners = {} if self.mesh is None else {
            d: BatchAligner(penalties, options, adaptive, k_win=k_win,
                            s_cap=s_cap, device=d, engine=engine_arg)
            for d in dict.fromkeys(self.mesh.devices)}

    def align_batch(self, pairs: Sequence[Tuple[bytes, bytes]],
                    fallback: bool = True) -> List[Optional[AlignmentResult]]:
        """Align a batch; results in input order.  Raises EmptySeqError /
        SeqTooLongError on invalid pairs (wfa.go:204-209)."""
        for q, t in pairs:
            if len(q) == 0 or len(t) == 0:
                raise EmptySeqError("wfa: invalid empty sequence")
            if len(q) > MAX_SEQ_LEN or len(t) > MAX_SEQ_LEN:
                raise SeqTooLongError(
                    f"wfa: sequences longer than {MAX_SEQ_LEN} are not "
                    "supported")
        return self.finish_batch(self.submit_batch(pairs), fallback)

    def pack_batch(self, pairs: Sequence[Tuple[bytes, bytes]]):
        """Pad a batch and pre-place each target at column -k0: (qb, tbuf,
        qlen, tlen, toff, Lq, Ltb), as ``wfa_tpu.engine.BatchAligner
        .pack_batch``."""
        return self._pack_all(pairs)[:7]

    def _pack_all(self, pairs, need_raw: bool = True):
        """:func:`_pack_all` at this aligner's window and mode."""
        return _pack_all(pairs, self.cfg.k_win, need_raw=need_raw,
                         global_alignment=self.cfg.global_alignment)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the device (:func:`upload`)."""
        trace.count(trace.BYTES_UP, a.nbytes)
        with trace.span(trace.UPLOAD):
            return upload(a, self.device)

    def _on_device(self):
        """Context that makes this aligner's card the thread's current
        device (nothing on the CPU): a worker thread starts on device 0,
        and the launches, the events and the copies must go to this one."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.device(self.device)

    def submit_batch(self, pairs: Sequence[Tuple[bytes, bytes]],
                     prepacked=None) -> Submitted:
        """Pack, upload and launch a batch, and queue its fetch; returns
        the handle for :meth:`finish_batch`.  ``prepacked`` (the tuple
        :func:`_pack_all` gives for the same pairs at this aligner's window
        and mode) skips the pack, so that one thread may pack while
        another submits; a mesh ignores it (its batch is padded first).

        One body serves a card and a mesh (wfa_tpu/engine.py:1640-1690,
        1786-1892): the batch is packed whole, so that its shapes and
        token plan are batch-wide, and each shard, ``(aligner, rows,
        context)``, uploads its rows and launches on its aligner's device
        inside its context.  One card is one shard of every row, in no
        span of its own; a mesh pads the batch to a multiple of its size
        and runs this process's shards, each inside its ``shard`` span
        (``DpMesh.on``).  Once every shard has launched, each shard's
        fetch is queued on its aligner.  Across processes a submit also
        waits for its shards, fetches them and gathers every process's,
        in one exchange."""
        if self.engine in ("long", "kw") and not self.cfg.global_alignment:
            # as pallas_longread.supports and pallas_run_batch's aux_kw
            # assert refuse semi-global
            raise ValueError(f"engine={self.engine!r} runs global alignment "
                             "only")
        pairs, mesh = list(pairs), self.mesh
        if mesh is None:
            batch = pairs
            shards = [(self, slice(0, len(pairs)), contextlib.nullcontext)]
        else:
            batch = pairs + [(b"A", b"A")] * ((-len(pairs)) % mesh.size)
            prepacked = None
            shards = [(self._shard_aligners[dev], rows,
                       functools.partial(mesh.on, i))
                      for i, dev, rows in mesh.shards(len(batch))]
        trace.count(trace.AUX_ROWS, self.cfg.s_cap * len(batch))
        submit = (self._submit_semi2 if self.engine == "semi2"
                  else self._submit)
        if mesh is None:
            with self._on_device():
                return submit(batch, prepacked, shards)()[0][1]
        run = submit(batch, prepacked, shards)
        if mesh.world == 1:
            return Submitted(pairs, {}, False, parts=run())

        def local():
            parts = run()
            got = []
            for eng, h in parts:
                eng._fetch_rest(h)
                eng._await_copies(h)
                with trace.span(trace.BUILD):
                    got.append(eng._splice(h))
            if any(h.missed for _, h in parts):
                trace.count(trace.REFETCHES)
            return got

        lb = len(batch) // mesh.size
        tokens = [t for got in mesh.exchange(local) for t in got]
        return Submitted(pairs, {}, False, parts=[
            (self, Submitted(batch[g * lb:(g + 1) * lb], {}, False,
                             tokens=t)) for g, t in enumerate(tokens)])

    @staticmethod
    def _launch(shards, seq, lens, kernels) -> list:
        """Each shard's rows of the host arrays ``seq`` and ``lens``
        uploaded to its aligner's device (:meth:`_upload`) and
        ``kernels(seq, lens, i)`` launched there, for shard i, all inside
        the shard's context: the outputs, in shard order."""
        outs = []
        for i, (eng, rows, on) in enumerate(shards):
            with on():
                s, n = eng._upload(seq[rows]), eng._upload(lens[rows])
                with trace.span(trace.LAUNCH):
                    outs.append(kernels(s, n, i))
        return outs

    def _launch_fetch(self, batch, shards, seq, lens, kernels,
                      edit: bool) -> list:
        """:meth:`_launch`, and each shard's fetch queued on its aligner
        (:meth:`_queue_fetch`): [(aligner, handle)], in shard order.  One
        card queues its fetch in its launch span; a mesh once every shard
        has launched, outside the shards' spans, each in a launch span of
        its own, so that no shard's launch waits for another's fetch."""
        if self.mesh is None:
            return self._launch(shards, seq, lens, lambda s, n, i: (
                self, self._queue_fetch(batch, kernels(s, n, i), edit)))
        parts = []
        for (eng, rows, _), out in zip(
                shards, self._launch(shards, seq, lens, kernels)):
            with eng._on_device(), trace.span(trace.LAUNCH):
                parts.append((eng, eng._queue_fetch(batch[rows], out, edit)))
        return parts

    def _submit(self, batch, prepacked, shards):
        """The global routes' submit: pack the batch and return the step
        that runs ``align_full2`` on each shard and queues the fetches
        (:meth:`submit_batch`)."""
        with trace.span(trace.PACK):
            seq, lens, packed, Lq, Ltb = _seq_lens(
                prepacked if prepacked is not None
                else self._pack_all(batch, need_raw=False))
        edit = edit_only(self.cfg)  # fixed here; the decode follows it

        def kernels(s, n, _):
            return align_full2(s, n, cfg=self.cfg, B=n.shape[0], Lq=Lq,
                               Ltb=Ltb, packed=packed, edit=edit,
                               engine=self.engine)

        return lambda: self._launch_fetch(batch, shards, seq, lens, kernels,
                                          edit)

    def _submit_semi2(self, batch, prepacked, shards):
        """The two-phase semi-global submit (wfa_tpu/engine.py:1774-1892):
        pack the whole batch and take its full span; K3 at the full span
        on each shard; the mid-point on the whole batch: every shard's
        ``meta1`` k0-to-diagonal column fetched (the one mid-point sync)
        and gathered from every process, and each target re-placed for its
        window (``Ltb2`` batch-wide); returns the step that runs K4 and K2
        over both aux tensors on each shard and queues the fetches
        (:meth:`submit_batch`)."""
        from .semi2 import (M1_K02, phase2, prefix_export, prefix_span,
                            replace_targets)

        # the raw query rows go with a re-placed target that is not ACGT
        with trace.span(trace.PACK):
            packed_batch = (prepacked if prepacked is not None
                            else self._pack_all(batch))
            qb, _, qlen, tlen, _, _, _, qp, _ = packed_batch
            seq, lens, packed, Lq, Ltb = _seq_lens(packed_batch)
            Kf = prefix_span(qlen, tlen)
        self.spans.add(Kf)
        pcfg = dataclasses.replace(self.cfg, k_win=Kf)
        exports = []

        def phase1():
            exports.extend(self._launch(shards, seq, lens, lambda s, n, _: (
                prefix_export(s, n, cfg=pcfg, Lq=Lq, Ltb=Ltb,
                              S0=self.s_switch, K2=self.cfg.k_win,
                              packed=packed))))
            with trace.span(trace.WAIT):
                return [ex["meta1"][:, M1_K02].cpu().numpy()
                        for ex in exports]

        got = ([phase1()] if self.mesh is None
               else self.mesh.exchange(phase1))  # every process's
        k02 = np.concatenate([m for part in got for m in part])
        with trace.span(trace.PACK):
            t2raw, t2p, toff2, Ltb2 = replace_targets(
                [t for _, t in batch], k02)
            packed2 = packed and t2p is not None
            seq2 = np.concatenate([qp, t2p] if packed2 else [qb, t2raw],
                                  axis=1)
            lens2 = np.stack([qlen, tlen, toff2], axis=1).astype(np.int32)

        def kernels(s, n, i):
            return phase2(
                s, n, *(exports[i][k] for k in (
                    "win_m", "win_i", "win_d", "ainit", "b_m", "b_ie",
                    "meta1", "aux_old")),
                cfg=self.cfg, Lq=Lq, Ltb_full=Ltb, Ltb2=Ltb2,
                S0=self.s_switch, packed=packed2)

        return lambda: self._launch_fetch(batch, shards, seq2, lens2,
                                          kernels, False)

    # -- the split fetch (wfa_tpu/engine.py:1698-1772, 1899-2064) ----------

    def _on_copy(self):
        """Context that makes the copy stream current (nothing on the
        CPU)."""
        if self._copy is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._copy)

    def _host(self, a: torch.Tensor) -> torch.Tensor:
        """Queue the copy of device tensor ``a`` into a pinned buffer on
        the copy stream (within :meth:`_on_copy`) and return the buffer;
        ``a`` itself on the CPU.  ``record_stream`` keeps the allocator
        from reusing ``a`` before the copy has run."""
        trace.count(trace.BYTES_DOWN, a.numel() * a.element_size())
        if self._copy is None:
            return a
        h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
        h.copy_(a, non_blocking=True)
        a.record_stream(self._copy)
        return h

    def _copied(self) -> Optional[torch.cuda.Event]:
        """An event after the copies queued so far (None on the CPU)."""
        if self._copy is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self._copy)
        return ev

    def _queue_fetch(self, pairs, out: dict, edit: bool) -> Submitted:
        """Queue the host copies of a launched batch's outputs: the small
        ones whole, and the token streams at the guessed extent ("mtb": the
        meta bytes and, cold, 64 token bytes a pair; "lg" and the raw "buf"
        once a batch has calibrated them)."""
        h = Submitted(pairs, out, edit)
        if self._copy is not None:
            h.ran = torch.cuda.Event()
            # on the stream the launches went to (``_build.stream_ptr``)
            h.ran.record(torch.cuda.current_stream(self.device))
            self._copy.wait_event(h.ran)
        streams = ("mtb", "lg", "buf")
        with self._on_copy():
            h.host = {k: self._host(a) for k, a in out.items()
                      if k not in streams}
            guess = self._tok_guess
            if "mtb" in out:
                hd = out["mtb"].shape[0] - out["lg"].shape[0]
                gb = guess["mtb"] or _coarse(64 * len(pairs))
                h.host["mtb"] = self._host(out["mtb"][:hd + gb])
                if guess["lg"]:
                    h.host["lg"] = self._host(out["lg"][:guess["lg"]])
            elif guess["buf"]:
                h.host["buf"] = self._host(out["buf"][:guess["buf"]])
            h.copied = self._copied()
        return h

    @staticmethod
    def wait_exec(h: Submitted) -> None:
        """Block until the batch's last launch has run on the device (no
        wait on the CPU, where the launches ran in the submit)."""
        for _, part in h.parts or ():
            BatchAligner.wait_exec(part)
        if h.ran is not None:
            with trace.span(trace.WAIT):
                h.ran.synchronize()

    def finish_small(self, h: Submitted) -> Submitted:
        """Wait for the queued copies, read the meta, update the guessed
        extents (the used extent and 1/8 more) and queue the copies of
        whatever the guess missed; returns the handle for
        :meth:`finish_tokens`.  A batch whose guess missed (a mesh's: in
        any shard) counts one refetch."""
        if h.parts is not None or h.tokens is not None:
            for eng, part in h.parts or ():
                if part.tokens is None:  # not gathered already
                    eng._fetch_rest(part)
            h.missed = any(part.missed for _, part in h.parts or ())
        else:
            self._fetch_rest(h)
        if h.missed:
            trace.count(trace.REFETCHES)
        return h

    @staticmethod
    def _await_copies(h: Submitted) -> None:
        """Block until the copies queued for the batch so far have landed
        (no wait on the CPU)."""
        with trace.span(trace.WAIT):
            if h.copied is not None:
                h.copied.synchronize()

    def _fetch_rest(self, h: Submitted) -> Submitted:
        """:meth:`finish_small` of one device's handle."""
        self._await_copies(h)
        out, host = h.out, h.host
        rest = {}  # what the guess missed, by the host copy's name
        if "mtb" in out:
            hd = out["mtb"].shape[0] - out["lg"].shape[0]
            head = host["mtb"].numpy()
            h.meta = _meta_from_bytes(head[:hd], len(h.pairs))
            tot_b = int(h.meta[:, M_TRIM].sum(dtype=np.int64))
            tot_l = int(h.meta[:, M_LONG].sum(dtype=np.int64))
            self._tok_guess["mtb"] = _coarse(max(tot_b, 1) * 9 // 8)
            self._tok_guess["lg"] = _coarse(max(tot_l, 1) * 9 // 8)
            have_b = head.shape[0] - hd
            if have_b < tot_b:
                rest["mtb_rest"] = out["mtb"][hd + have_b:hd + tot_b]
            have_l = host["lg"].shape[0] if "lg" in host else 0
            if have_l < tot_l:
                rest["lg_rest"] = out["lg"][have_l:tot_l]
        else:
            # raw layout: the trim column is the chase's iteration
            # count, the same for every pair; buf's rows past it are 0
            h.meta = host["meta"].numpy().astype(np.int32)
            rows = int(h.meta[:, M_TRIM].max())
            self._tok_guess["buf"] = _coarse(max(rows, 1) * 9 // 8, 32)
            have = host["buf"].shape[0] if "buf" in host else 0
            if have < rows:
                rest["buf_rest"] = out["buf"][have:rows]
        if rest:
            h.missed = True
            with self._on_copy(), trace.span(trace.LAUNCH):
                host.update((k, self._host(a)) for k, a in rest.items())
                h.copied = self._copied()
        return h

    def finish_tokens(self, h: Submitted, fallback: bool = True
                      ) -> List[Optional[AlignmentResult]]:
        """Wait for the remainder copies, splice the token streams, release
        the batch's device outputs and build its results (op decoding is
        lazy, on first access); a mesh's batch, each shard's in turn, the
        padding dropped."""
        if h.parts is not None:
            results = []
            for eng, part in h.parts:
                results += eng.finish_tokens(part, fallback)
            h.parts = None
            return results[:len(h.pairs)]
        if h.tokens is None:
            self._await_copies(h)
        with trace.span(trace.BUILD):
            meta, toks, edit, final = self._splice(h)
            return self._results(h.pairs, meta, toks, edit, final, fallback)

    def _results(self, pairs, meta, toks, edit, final, fallback):
        """:meth:`finish_tokens`' result objects from the spliced
        streams."""
        results: List[Optional[AlignmentResult]] = []
        oracle = self._oracle
        ga = self.cfg.global_alignment
        used = 0  # aux rows the served pairs used
        for (q, t), score, fs, ovf, tk in zip(
                pairs, meta[:, M_SCORE].tolist(), final,
                meta[:, M_OVF].tolist(), toks):
            if ovf:
                results.append(oracle.align(q, t) if fallback else None)
            else:
                used += fs + 1
                res = DeviceResult.from_device(
                    ga, score, (tk, q, t) if edit else tk)
                res.final_s = fs
                if not ga:
                    res.lens = (len(q), len(t))
                results.append(res)
        trace.count(trace.AUX_ROWS_USED, used)
        return results

    def _splice(self, h: Submitted) -> tuple:
        """Splice the token streams of a batch whose copies have landed
        (:meth:`_await_copies`) and release its device outputs: (meta
        int32[B, 4], per-pair token arrays, whether they are edit-only,
        final_s list)."""
        if h.tokens is not None:
            return h.tokens
        host = {k: a.numpy() for k, a in h.host.items()}
        meta, edit = h.meta, h.edit
        if "mtb" in h.out:
            hd = h.out["mtb"].shape[0] - h.out["lg"].shape[0]
            b = host["mtb"][hd:]
            if "mtb_rest" in host:
                b = np.concatenate([b, host["mtb_rest"]])
            longs = [host[k] for k in ("lg", "lg_rest") if k in host]
            longs = (np.concatenate(longs) if longs else np.zeros(
                0, np.int16 if h.out["lg"].dtype == torch.int16
                else np.int32))
            toks = _split_tokens(meta, b, longs)
        else:
            rows = int(meta[:, M_TRIM].max())
            parts = [host[k] for k in ("buf", "buf_rest") if k in host]
            buf = (np.concatenate(parts)[:rows] if parts
                   else np.zeros((0,) + tuple(h.out["buf"].shape[1:]),
                                 host["tok0"].dtype))
            _, toks = assemble_raw(h.pairs, {**host, "buf": buf})
            edit = False  # raw full streams
        final = (host["final_s"].tolist() if "final_s" in host
                 else meta[:, M_SCORE].tolist())
        # drop the device outputs now (their copies have landed): retry
        # tiers allocate large batches that must not wait for the GC
        h.out = h.host = None
        return meta, toks, edit, final

    def finish_batch(self, h: Submitted, fallback: bool = True
                     ) -> List[Optional[AlignmentResult]]:
        """Fetch a submitted batch and build its results:
        ``finish_tokens(finish_small(h))``."""
        return self.finish_tokens(self.finish_small(h), fallback)
