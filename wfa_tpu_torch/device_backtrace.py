"""Device backtrace, semi-global end finder and token compaction,
PyTorch port of :mod:`wfa_tpu.device_backtrace` (one aux tensor, or the
two-phase semi-global route's two).

Kernel K2 (``csrc/backtrace.cu``, wrapper :func:`device_backtrace`)
replaces the JAX package's ``device_backtrace`` ``lax.while_loop``
(wfa_tpu/device_backtrace.py:276-547): one thread per pair chases the
backtrace through the aux tensor ``int32[3, S, B, K]`` that the score loop
baked (``offset0 << 3 | tag`` per cell), reading ONE aux cell per step and
emitting op tokens ``code << token_shift | run`` into the same
iteration-major slots.  :func:`device_backtrace_plain` is its plain PyTorch
version: all pairs step in lockstep, one launch per op per step.

Both are exact ports of the reference backtrace loop (wfa.go:703-983),
with the deferred tag read of the stepped-into cell, the post-loop
pending tag, the ``it < it_cap - 1`` stop and, in semi-global mode, the
stop on the first row or column.

:func:`end_finder_plain` is the semi-global end finder over a stored M
history; kernel K1 fuses the same search into its score loop.
:func:`device_stats` computes a result's stats from its token stream in
torch ops (an XLA op sequence in the JAX package, not on the main path:
the host decode derives the stats).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import count
from .constants import (
    T_DEL_EXT,
    T_DEL_OPEN,
    T_INS_EXT,
    T_INS_OPEN,
    T_MISMATCH,
    TYPE_BITS,
)

CODE_M, CODE_X, CODE_I, CODE_D, CODE_H = 0, 1, 2, 3, 4
OP_CHARS = "MXIDH"
# gap-extension codes of the edit-only token stream (decoders map 5 -> I,
# 6 -> D): no match run can precede an extension step
CODE_IE, CODE_DE = 5, 6
# tag (0..7) -> op code; tags 1,2 -> I; 3,4 -> D; 5 -> X; 6 -> M
_TAG2CODE = np.array([7, CODE_I, CODE_I, CODE_D, CODE_D, CODE_X, CODE_M, 7],
                     dtype=np.int32)
_TAG2CODE_SPLIT = np.array(
    [7, CODE_I, CODE_IE, CODE_D, CODE_DE, CODE_X, CODE_M, 7], dtype=np.int32)

COMP_M, COMP_I, COMP_D = 0, 1, 2


def iter_capacity(s_cap: int, penalties) -> int:
    """Upper bound on backtrace loop iterations: every step lowers the
    score by at least min(mismatch, gap_ext) (wfa.go:884-909)."""
    step = max(1, min(penalties.mismatch, penalties.gap_ext))
    return s_cap // step + 4


def _tok_dtype(token_shift: int):
    return torch.int16 if token_shift <= 12 else torch.int32


def end_finder_plain(hist_m, k0, final_s, qlen, tlen, S: int, K: int):
    """Semi-global end finder (wfa.go:270-375) over the M history
    ``hist_m`` int32[S, B, K], equal to ``wfa_tpu.device_backtrace
    .end_finder``.  Per stored score row s <= final_s the nearest *stop*
    cell on each side of Ak decides (the first bound-violating cell fails
    a direction, the first last-row/column cell succeeds); the lowest
    successful score wins, its up side first.  Returns (end_s, end_k,
    found), falling back to (final_s, Ak)."""
    dev = hist_m.device
    i32 = torch.int32
    ks = k0[None, :, None] + torch.arange(K, device=dev, dtype=i32)
    n = qlen[None, :, None]
    m = tlen[None, :, None]
    s_rows = torch.arange(S, device=dev, dtype=i32)[:, None, None]
    okc = (hist_m > 0) & (s_rows <= final_s[None, :, None])
    h = hist_m >> TYPE_BITS
    v = h - ks
    viol = (v <= 0) | (v > n) | (h > m)
    elig = ((v == n) & (h >= n)) | ((h == m) & (v >= m))
    stop = okc & (viol | elig)
    succ = okc & ~viol & elig
    Ak = (tlen - qlen)[None, :, None]
    big = 1 << 30
    stop_dn = stop & (ks <= Ak)
    k_dn = torch.where(stop_dn, ks, -big).amax(dim=2)  # [S, B]
    succ_dn = (succ & (ks <= Ak) & (ks == k_dn[:, :, None])).any(dim=2)
    stop_up = stop & (ks >= Ak + 1)
    k_up = torch.where(stop_up, ks, big).amin(dim=2)
    succ_up = (succ & (ks >= Ak + 1) & (ks == k_up[:, :, None])).any(dim=2)
    row_ok = succ_dn | succ_up
    s_idx = torch.arange(S, device=dev, dtype=i32)[:, None]
    min_s = torch.where(row_ok, s_idx, big).amin(dim=0)  # [B]
    found = min_s < big
    sc = min_s.clamp(0, S - 1).long()[None, :]
    up_at = torch.gather(succ_up, 0, sc)[0]
    k_sel = torch.where(up_at, torch.gather(k_up, 0, sc)[0],
                        torch.gather(k_dn, 0, sc)[0])
    return (torch.where(found, min_s, final_s),
            torch.where(found, k_sel, tlen - qlen), found)


def device_backtrace_plain(
    aux, start_cell, k0, start_s, start_k, qlen, tlen, active0, *,
    penalties, S: int, K: int, token_shift: int,
    split_ext_codes: bool = False, global_alignment: bool = True,
    aux_base=None, aux_old=None, k0_old=None, s_split: int = 0,
    aux_sbase=None, return_iters: bool = False, it_cap=None,
):
    """Plain PyTorch version of kernel K2.

    ``aux`` is int32 or int16 [3, S, B, K], or with ``aux_base``
    (int32[B, S]) the value-rebased int16[3, S, B, K] of the long-read
    score loop, whose found cells hold ``offset0 - aux_base[b, s] + 1``
    (wfa_tpu/device_backtrace.py:379-383), or with ``aux_sbase``
    (int32[S, B]) K1-kw's int16[3, S, B, K] (K = KW): row s of pair b
    holds window columns from ``(sbase & 31) * 32`` on, its found cells
    ``offset0 - (sbase >> 5) + 1`` (device_backtrace.py:332-334,
    352-355, 384-385); ``start_cell`` the raw M cell
    at (start_s, start_k).  The two-phase semi-global route passes
    ``aux`` [3, S - s_split, B, K] for scores s_split .. S - 1 and
    ``aux_old`` [3, s_split, B, Kf] for the scores below, read at window
    origins ``k0_old`` (device_backtrace.py:281, 335-375).

    Returns (tok0 [B], buf [it_cap, B, 2], tail [B, 4]): op tokens in emission order tok0, buf[0], buf[1], ...,
    tail, zero = empty slot, int16 when ``token_shift`` <= 12; with
    ``return_iters`` also int32[B], the chase iterations each pair ran
    (their maximum is the JAX loop's iteration count).  A semi-global
    chase stops once it reaches the first row or column.  ``it_cap``
    (default ``iter_capacity(S, penalties)``) sets the rows of ``buf``
    and the most iterations: a loop run at a stride passes the capacity
    of the scores it stands for, so that its stream keeps their layout."""
    dev = aux.device
    B = qlen.shape[0]
    i32 = torch.int32
    x = penalties.mismatch
    oe = penalties.gap_open + penalties.gap_ext
    e = penalties.gap_ext
    if it_cap is None:
        it_cap = iter_capacity(S, penalties)
    tok_dtype = _tok_dtype(token_shift)
    Sn = S - s_split  # rows held by aux
    flat = aux.reshape(3 * Sn * B, K)
    if aux_old is not None:
        Kf = aux_old.shape[3]
        flat_old = aux_old.reshape(3 * s_split * B, Kf)
        k0_old = k0_old.to(torch.int32)
    bidx = torch.arange(B, device=dev, dtype=torch.long)
    code_tab = torch.as_tensor(
        _TAG2CODE_SPLIT if split_ext_codes else _TAG2CODE, device=dev)
    qlen, tlen, k0 = qlen.to(i32), tlen.to(i32), k0.to(i32)

    def pack(code, n):
        return (code << token_shift) | n

    def read_aux(s, comp, k):
        """(offset0, tag, found) of the aux cell at (s, comp, k)."""
        j = k - k0
        sc = s.clamp(0, S - 1).long()
        if aux_sbase is not None:
            sbv = aux_sbase[sc, bidx]
            j = j - (sbv & 31) * 32
        ok = (s >= s_split) & (s < S) & (j >= 0) & (j < K)
        row = (comp.long() * Sn + (s - s_split).clamp(0, Sn - 1)) * B + bidx
        cell = flat[row, j.clamp(0, K - 1).long()].to(i32)
        if aux_old is not None:
            j_o = k - k0_old
            ok_o = (s >= 0) & (s < s_split) & (j_o >= 0) & (j_o < Kf)
            row_o = ((comp.long() * s_split + s.clamp(0, s_split - 1)) * B
                     + bidx)
            cell_o = flat_old[row_o, j_o.clamp(0, Kf - 1).long()].to(i32)
            use_old = s < s_split
            cell = torch.where(use_old, cell_o, cell)
            ok = torch.where(use_old, ok_o, ok)
        found = ok & (cell > 0)
        cell = torch.where(found, cell, 0)
        off = cell >> TYPE_BITS
        if aux_base is not None:
            off = torch.where(found, off - 1 + aux_base[bidx, sc], 0)
        if aux_sbase is not None:
            off = torch.where(found, off - 1 + (sbv >> 5), 0)
        return off, cell & ((1 << TYPE_BITS) - 1), found

    # ---- start point (wfa.go:738-750); existence deliberately unchecked
    tag = start_cell & ((1 << TYPE_BITS) - 1)
    h = start_cell >> TYPE_BITS
    v = h - start_k
    buf = torch.zeros((it_cap, B, 2), dtype=tok_dtype, device=dev)
    fl_i = h < tlen
    fl_h = ~fl_i & (v < qlen)
    tok0 = torch.where(
        active0 & (fl_i | fl_h),
        pack(torch.where(fl_i, CODE_I, CODE_H),
             torch.clamp(torch.where(fl_i, tlen - h, qlen - v), min=0)),
        0).to(tok_dtype)

    alive = active0 & (v > 0) & (h > 0)
    pfm = torch.ones(B, dtype=torch.bool, device=dev)  # previousFromM
    s = start_s.to(i32)
    k = start_k.to(i32)
    comp = torch.full((B,), COMP_M, dtype=i32, device=dev)
    pending = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=i32, device=dev)
    it = 0
    while bool(alive.any()):
        iters += alive.to(i32)
        # ONE aux read: the tag of the cell stepped into last iteration
        # (wfa.go:915-920, deferred) and this cell's offset0
        offset0, tag_new, tag_ok = read_aux(s, comp, k)
        alive = alive & ~(pending & ~tag_ok)
        tag = torch.where(pending & tag_ok, tag_new, tag)
        is_ie = tag == T_INS_EXT
        is_de = tag == T_DEL_EXT
        # offset0 == 0 covers the from-itself break and the offset0 == 0
        # break (wfa.go:819-827)
        cont = alive & (offset0 != 0)

        # traceback matches (wfa.go:832-869)
        nmatch = h - offset0
        emit1 = cont & pfm & (nmatch > 0)
        tok_m = torch.where(emit1, pack(CODE_M, nmatch.clamp(min=0)), 0)
        upd_hv = cont & pfm
        h = torch.where(upd_hv, offset0, h)
        v = torch.where(upd_hv, h - k, v)
        cont2 = cont & ~(upd_hv & ((h <= 0) | (v <= 0)))

        # record the current op (wfa.go:871-874)
        tok_op = torch.where(cont2, pack(code_tab[tag.long()], 1), 0)
        buf[it] = torch.stack([tok_m, tok_op], dim=1).to(tok_dtype)
        if not global_alignment:  # a seed cell is the path's start
            cont2 = cont2 & ~((h == 1) | (v == 1))

        # step to the source cell (wfa.go:884-909)
        is_mis = tag == T_MISMATCH
        is_io = tag == T_INS_OPEN
        is_do = tag == T_DEL_OPEN
        step = cont2 & (is_mis | is_io | is_ie | is_do | is_de)
        s_n = torch.where(is_mis, s - x,
                          torch.where(is_io | is_do, s - oe, s - e))
        k_n = k + torch.where(is_io | is_ie, -1,
                              torch.where(is_do | is_de, 1, 0))
        h_n = h + torch.where(is_mis | is_io | is_ie, -1, 0)
        s = torch.where(step, s_n, s)
        k = torch.where(step, k_n, k)
        h = torch.where(step, h_n, h)
        v = torch.where(step, h - k, v)
        pfm = torch.where(step, ~(is_ie | is_de), pfm)
        comp = torch.where(
            step, torch.where(is_ie, COMP_I, torch.where(is_de, COMP_D, COMP_M)),
            comp).to(i32)
        pending = step
        alive = step & (v > 0) & (h > 0) & (it < it_cap - 1)
        it += 1

    # a pair that stepped in its last iteration still owes the tag read;
    # the reference updates the tag before its loop check (wfa.go:915-920)
    _, tag_p, ok_p = read_aux(s, comp, k)
    tag = torch.where(pending & ok_p, tag_p, tag)

    # ---- the last one (wfa.go:930-968)
    tl = active0 & (h > 0) & (v > 0)
    nm = torch.minimum(h, v) - 1
    e1 = tl & (nm > 0)
    tok_a = torch.where(e1, pack(CODE_M, nm.clamp(min=0)), 0)
    h = torch.where(e1, h - nm, h)
    v = torch.where(e1, v - nm, v)
    tok_b = torch.where(tl, pack(code_tab[tag.long()], 1), 0)
    # leading flanks (wfa.go:970-976)
    tok_c = torch.where(active0 & (v > 1), pack(CODE_H, (v - 1).clamp(min=0)), 0)
    tok_d = torch.where(active0 & (h > 1), pack(CODE_I, (h - 1).clamp(min=0)), 0)
    tail = torch.stack([tok_a, tok_b, tok_c, tok_d], dim=1).to(tok_dtype)
    if return_iters:
        return tok0, buf, tail, iters
    return tok0, buf, tail


def device_backtrace(
    aux, start_cell, k0, start_s, start_k, qlen, tlen, active0, *,
    penalties, S: int, K: int, token_shift: int,
    split_ext_codes: bool = False, global_alignment: bool = True,
    aux_base=None, aux_old=None, k0_old=None, s_split: int = 0,
    aux_sbase=None, return_iters: bool = False, it_cap=None,
):
    """Kernel K2 (same contract as :func:`device_backtrace_plain`).

    CUDA tensors launch ``wfa_backtrace`` (csrc/backtrace.cu) on the
    current stream; CPU tensors take the plain version.  Bound on the
    card by the latency of one dependent aux read per step (~it_cap
    steps; over K1-kw's aux two: the sbase word, then the cell it
    places), which one thread per pair hides across the batch."""
    if aux.device.type == "cpu":
        return device_backtrace_plain(
            aux, start_cell, k0, start_s, start_k, qlen, tlen, active0,
            penalties=penalties, S=S, K=K, token_shift=token_shift,
            split_ext_codes=split_ext_codes,
            global_alignment=global_alignment, aux_base=aux_base,
            aux_old=aux_old, k0_old=k0_old, s_split=s_split,
            aux_sbase=aux_sbase, return_iters=return_iters, it_cap=it_cap)
    from ._build import check_inputs, launch, stream_ptr

    B = qlen.shape[0]
    i32 = torch.int32
    rebased = aux_base is not None
    kw = aux_sbase is not None
    dual = aux_old is not None
    if (rebased or kw) and (dual or (rebased and kw)
                            or aux.dtype != torch.int16):
        raise ValueError("device_backtrace: rebased aux is int16 and alone")
    if aux.dtype not in (torch.int16, i32):
        raise TypeError(f"device_backtrace: aux is {aux.dtype}")
    check_inputs("device_backtrace", aux.device,
                 aux=(aux, aux.dtype, (3, S - s_split, B, K)),
                 start_cell=(start_cell, i32, (B,)), k0=(k0, i32, (B,)),
                 start_s=(start_s, i32, (B,)), start_k=(start_k, i32, (B,)),
                 qlen=(qlen, i32, (B,)), tlen=(tlen, i32, (B,)),
                 active0=(active0, torch.bool, (B,)))
    if rebased:
        check_inputs("device_backtrace", aux.device,
                     aux_base=(aux_base, i32, (B, S)))
    if kw:
        check_inputs("device_backtrace", aux.device,
                     aux_sbase=(aux_sbase, i32, (S, B)))
    Kf = 0
    if dual:
        Kf = aux_old.shape[3]
        if aux_old.dtype not in (torch.int16, i32):
            raise TypeError(f"device_backtrace: aux_old is {aux_old.dtype}")
        check_inputs("device_backtrace", aux.device,
                     aux_old=(aux_old, aux_old.dtype, (3, s_split, B, Kf)),
                     k0_old=(k0_old, i32, (B,)))
    elif s_split:
        raise ValueError("device_backtrace: s_split needs aux_old")
    if it_cap is None:
        it_cap = iter_capacity(S, penalties)
    tok_dtype = _tok_dtype(token_shift)
    dev = aux.device
    tok0 = torch.empty(B, dtype=tok_dtype, device=dev)
    buf = torch.empty((it_cap, B, 2), dtype=tok_dtype, device=dev)
    tail = torch.empty((B, 4), dtype=tok_dtype, device=dev)
    iters = torch.empty(B, dtype=i32, device=dev)
    p = penalties
    c16 = [ctypes.c_int(int(a is not None and a.dtype == torch.int16))
           for a in (aux, aux_old)]
    launch("wfa_backtrace",
           aux, c16[0], aux_base, aux_sbase, aux_old, c16[1],
           ctypes.c_int(s_split),
           ctypes.c_int(Kf), k0_old if dual else None,
           start_cell, k0, start_s, start_k, qlen, tlen,
           active0, ctypes.c_int(B), ctypes.c_int(S), ctypes.c_int(K),
           ctypes.c_int(p.mismatch), ctypes.c_int(p.gap_open + p.gap_ext),
           ctypes.c_int(p.gap_ext), ctypes.c_int(it_cap),
           ctypes.c_int(token_shift), ctypes.c_int(int(split_ext_codes)),
           ctypes.c_int(int(not global_alignment)), tok0, buf, tail, iters,
           stream_ptr(dev))
    mode = ("long" if rebased else "kw" if kw else "semi2" if dual
            else "global" if global_alignment else "semi")
    count(device_backtrace.launches, mode)
    if return_iters:
        return tok0, buf, tail, iters
    return tok0, buf, tail


# launches per mode of the kernel (global, semi-global, global over the
# long-read score loop's value-rebased int16 aux, global over K1-kw's row-
# and value-rebased aux, and semi-global over the two-phase route's two
# aux tensors)
device_backtrace.launches = {"global": 0, "semi": 0, "long": 0, "kw": 0,
                             "semi2": 0}


def _emission_order(tok0, buf, tail) -> torch.Tensor:
    """The token slots of each pair in emission order: int32[B, NS],
    tok0, buf[0], buf[1], ..., tail."""
    B = tok0.shape[0]
    return torch.cat(
        [tok0[:, None], buf.permute(1, 0, 2).reshape(B, -1), tail],
        dim=1).to(torch.int32)


def device_stats(tok0, buf, tail, token_shift: int = 28):
    """Vectorized AlignmentResult.process stats (wfa_cigar.go:171-211), in
    torch ops on the tokens' own device, equal to the JAX
    ``device_stats`` (wfa_tpu/device_backtrace.py:133-197).

    Works directly on the emission-order token stream (tok0, buf rows,
    tail), which is the reverse of the final op order; zero tokens are
    empty slots.  Stats cover merged ops between the first and last M
    run: in emission order that is the span [first M token, last M token],
    and a merged gap region starts wherever an I/D token's previous
    non-empty token (emission order) has a different code.

    Returns (align_len, matches, gaps, gap_regions), each int32[B]."""
    toks = _emission_order(tok0, buf, tail)
    B, NS = toks.shape
    code = toks >> token_shift
    # the edit-only stream's split extension codes are I and D here
    code = torch.where(code == CODE_IE, CODE_I,
                       torch.where(code == CODE_DE, CODE_D, code))
    run = toks & ((1 << token_shift) - 1)
    nz = toks != 0
    pos = torch.arange(NS, dtype=torch.int32, device=toks.device)[None, :]

    def first(mask):
        return torch.where(mask, pos, NS).amin(1, keepdim=True)

    def last(mask):
        return torch.where(mask, pos, -1).amax(1, keepdim=True)

    def total(mask, values):
        return torch.where(mask, values, 0).sum(1, dtype=torch.int32)

    is_m = nz & (code == CODE_M)
    first_m, last_m = first(is_m), last(is_m)
    # Go's begin/end default to index 0 when no M exists
    # (wfa_cigar.go:171-187): the span is then the first final-order
    # merged op, the whole trailing emission-order run of non-empty
    # tokens sharing the last token's code
    has_m = last_m >= 0
    last_nz = last(nz)
    last_code = torch.where(nz & (pos == last_nz), code, -1).amax(
        1, keepdim=True)
    first_trail = first(nz & (pos > last(nz & (code != last_code))))
    first_m = torch.where(has_m, first_m, first_trail)
    last_m = torch.where(has_m, last_m, last_nz)
    span = nz & (pos >= first_m) & (pos <= last_m)
    is_gap = (code == CODE_I) | (code == CODE_D)
    # the previous non-empty token's code: a running max over
    # pos * 8 | code (monotone in pos), shifted right by one slot
    cm = torch.cummax(torch.where(nz, pos * 8 + code, -1), 1).values
    prev = torch.cat([torch.full_like(cm[:, :1], -1), cm[:, :-1]], 1)
    prev_in_span = (prev >= 0) & ((prev >> 3) >= first_m)
    region_start = span & is_gap & (~prev_in_span | ((prev & 7) != code))
    return (total(span, run), total(span & (code == CODE_M), run),
            total(span & is_gap, run), total(region_start, 1))


def compact_tokens_flat_u8(tok0, buf, tail, token_shift: int,
                           drop_m: bool = False):
    """Cross-pair byte-stream token compaction, equal to the JAX
    ``compact_tokens_flat_u8``: each token ships as one byte
    ``code << 5 | run`` when run <= 31, else as the placeholder 224 plus
    the full-width token in the second stream.  ``drop_m`` drops match
    runs (the host rebuilds them).  The order is (pair, emission
    position): a cumulative sum of the keep-mask gives each kept token
    its slot, and one scatter places it.

    Returns (bytes_flat uint8[B*NS], longs_flat [B*NS], n_tok int32[B],
    n_long int32[B]), both flats dense prefixes with trailing zeros."""
    toks = _emission_order(tok0, buf, tail)
    B, NS = toks.shape
    flat = toks.reshape(B * NS)
    nz = flat != 0
    code = flat >> token_shift  # tokens are non-negative
    if drop_m:
        nz = nz & (code != CODE_M)
    run = flat & ((1 << token_shift) - 1)
    long = nz & (run > 31)
    byte_plane = torch.where(long, 224, (code << 5) | run)

    def compact(keep, vals, dtype):
        dest = torch.where(keep, torch.cumsum(keep, 0) - 1, B * NS)
        out = torch.zeros(B * NS + 1, dtype=dtype, device=flat.device)
        out.scatter_(0, dest, vals.to(dtype))
        return out[:-1]

    bytes_flat = compact(nz, byte_plane, torch.uint8)
    longs_flat = compact(long, flat, _tok_dtype(token_shift))
    n_tok = nz.reshape(B, NS).sum(1, dtype=torch.int32)
    n_long = long.reshape(B, NS).sum(1, dtype=torch.int32)
    return bytes_flat, longs_flat, n_tok, n_long
