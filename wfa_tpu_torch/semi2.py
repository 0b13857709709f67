"""Two-phase semi-global alignment, the port of :mod:`wfa_tpu.semi2`.

Semi-global seeds span every diagonal, and wf-adaptive reduction cannot
trim the band until the best path pulls ahead, so the first scores span
~qlen + tlen diagonals; after that the live band collapses to tens.  The
route splits the run there:

* **Phase 1** (:func:`prefix_export`, kernel K3): scores 0 .. S0 - 1 at
  the full span Kf, with the fused end finder, keeping the full-span aux
  history (``aux_old``) for the backtrace.
* **Export**: per pair the union of the last WM = max(x, o+e) + 1 M bands
  and WE = e + 1 I/D bands (all that next() can still read) plus the
  terminal diagonal picks a narrow window of K2 diagonals at origin k02;
  the live rows are rebased into it in the circular windows' slot order.
* **Phase 2** (:func:`phase2`): the host re-places each target for its
  window (:func:`replace_targets`), kernel K4 resumes at score S0 in the
  narrow window, and K2 chases through both aux tensors (scores below S0
  in ``aux_old``).

Pairs whose band union is wider than K2, or whose band later leaves the
narrow window, report overflow and retry on the wider tiers; the last tier
is the full-span single-phase run.  Every public function keeps the JAX
package's layouts, so the tests compare the two value for value.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from . import native
from .engine import (EngineConfig, _finish_outputs, _pack2, _pad_len,
                     _unpack2, run_batch_plain, semi_cell16, windows)

# meta1 columns exported by phase 1
META1_COLS = ("done", "final_s", "term_cell", "end_found", "end_s",
              "end_k", "end_cell", "overflow2", "k02")
M1_DONE, M1_FS, M1_TERM, M1_EFOUND, M1_ES, M1_EK, M1_ECELL, M1_OVF, \
    M1_K02 = range(9)

_BIG = 1 << 30
_I32 = torch.int32


def prefix_span(qlen, tlen) -> int:
    """Kf, the full span phase 1 runs at: every diagonal of the batch's
    widest pair (qlen + tlen - 1) plus one, rounded up to 128."""
    return -(-(int((qlen + tlen).max()) + 1) // 128) * 128


def _rebase_rows(rows: torch.Tensor, d: torch.Tensor, K2: int) -> torch.Tensor:
    """out[b, j] = rows[b, j + d[b]] for j < K2, 0 where j + d[b] passes
    the row (wfa_tpu/semi2.py:115-131, as one gather)."""
    Kf = rows.shape[1]
    idx = d.long()[:, None] + torch.arange(K2, device=rows.device)[None, :]
    got = torch.gather(rows, 1, idx.clamp(max=Kf - 1))
    return torch.where(idx < Kf, got, 0)


def _gather_cell(hist, s, j, S: int, K: int) -> torch.Tensor:
    """GetRaw at per-pair (s, j) from a [S, B, K] history, 0 outside."""
    B = hist.shape[1]
    ok = (s >= 0) & (s < S) & (j >= 0) & (j < K)
    cell = hist[s.clamp(0, S - 1).long(), torch.arange(B, device=hist.device),
                j.clamp(0, K - 1).long()]
    return torch.where(ok, cell, 0)


def prefix_export_plain(qb, tbuf, qlen, tlen, toff, *, cfg: EngineConfig,
                        Lq: int, Ltb: int, S0: int, K2: int) -> dict:
    """Plain PyTorch version of kernel K3, the port of
    ``wfa_tpu.semi2.prefix_export_impl``: run the full-span prefix (scores
    0 .. S0 - 1; ``cfg.k_win`` is the full span Kf, ``cfg.s_cap`` the
    total score cap) and export the handoff to a K2-wide window.

    Returns a dict of tensors: ``win_m`` int32[WM, B, K2], ``win_i`` and
    ``win_d`` [WE, B, K2] (the window rows rebased, slot r holding the
    score in (S0 - W, S0] congruent to r mod W), ``ainit`` [3, B, K2] (aux
    row S0 before its reduce), ``b_m`` [3 WM, B] and ``b_ie`` [6 WE, B]
    (band lo, hi, ex rows per slot), ``meta1`` [B, 9] (:data:`META1_COLS`)
    and ``aux_old`` [3, S0, B, Kf], int16 when ``semi_cell16(Ltb)``."""
    WM, WE = windows(cfg.penalties)
    if S0 < WM:
        raise ValueError(f"S0 {S0} is below the window depth {WM}")
    Kf = cfg.k_win
    B = qb.shape[0]
    st = run_batch_plain(qb, tbuf, qlen, tlen, toff, Lq=Lq, Ltb=Ltb,
                         cfg=dataclasses.replace(cfg, s_cap=S0 + 1,
                                                 prefix=True))
    from .device_backtrace import end_finder_plain

    qlen, tlen, toff = qlen.to(_I32), tlen.to(_I32), toff.to(_I32)
    k0 = -toff
    Ak = tlen - qlen
    hist_m = st["hist_m"]
    # the end scan over the final rows 0 .. S0 - 1 (wfa.go:270-375)
    lim = torch.full((B,), S0 - 1, dtype=_I32, device=qb.device)
    end_s, end_k, end_found = end_finder_plain(hist_m, k0, lim, qlen, tlen,
                                               S0 + 1, Kf)
    end_cell = _gather_cell(hist_m, end_s, end_k - k0, S0 + 1, Kf)
    term_cell = _gather_cell(hist_m, st["final_s"], Ak - k0, S0 + 1, Kf)

    # the narrow window: the union of every band phase 2 can still read
    # (the last WM M rows, WE I and D rows) plus the terminal diagonal
    lo_u = torch.full((B,), _BIG, dtype=_I32, device=qb.device)
    hi_u = torch.full((B,), -_BIG, dtype=_I32, device=qb.device)
    for c, W in (("m", WM), ("i", WE), ("d", WE)):
        for s in range(S0 - W + 1, S0 + 1):
            ex = st[f"ex_{c}"][s]
            lo_u = torch.where(ex, torch.minimum(lo_u, st[f"lo_{c}"][s]), lo_u)
            hi_u = torch.where(ex, torch.maximum(hi_u, st[f"hi_{c}"][s]), hi_u)
    win_lo = torch.minimum(lo_u, Ak)
    win_hi = torch.maximum(hi_u, Ak)
    width = win_hi - win_lo + 1
    k02 = win_lo - torch.div(K2 - width, 2, rounding_mode="floor")
    k02 = torch.minimum(torch.maximum(k02, -(qlen - 1)),
                        torch.maximum(tlen - K2, -(qlen - 1)))
    # pairs still holding a wide band escape to the wider tiers; done
    # pairs skip phase 2, so any placement serves them
    overflow2 = st["overflow"] | ((width > K2) & ~st["done"])
    d = k02 - k0

    def slot_rows(c, W):
        """Rows and band rows per circular slot: slot r holds the score in
        (S0 - W, S0] congruent to r mod W."""
        srows = [S0 - ((S0 - slot) % W) for slot in range(W)]
        rows = torch.stack([_rebase_rows(st[f"hist_{c}"][s], d, K2)
                            for s in srows])
        bands = torch.cat([st[f"lo_{c}"][srows], st[f"hi_{c}"][srows],
                           st[f"ex_{c}"][srows].to(_I32)], dim=0)
        return rows, bands

    win_m, b_m = slot_rows("m", WM)
    win_i, b_i = slot_rows("i", WE)
    win_d, b_d = slot_rows("d", WE)
    aux = st["aux"]
    ainit = torch.stack([_rebase_rows(aux[c, S0], d, K2) for c in range(3)])
    meta1 = torch.stack(
        [st["done"].to(_I32), st["final_s"], term_cell, end_found.to(_I32),
         end_s, end_k, end_cell, overflow2.to(_I32), k02], dim=1)
    # the full-span aux history for the backtrace (rows 0 .. S0 - 1; row
    # S0's reduced form is phase 2's first row)
    aux_old = aux[:, :S0].contiguous()
    if semi_cell16(Ltb):
        aux_old = aux_old.to(torch.int16)
    return {"win_m": win_m, "win_i": win_i, "win_d": win_d, "ainit": ainit,
            "b_m": b_m, "b_ie": torch.cat([b_i, b_d], dim=0),
            "meta1": meta1, "aux_old": aux_old}


def canonical_exports(ex: dict) -> dict:
    """The phase-1 exports with their don't-cares zeroed, so that K3 and
    its plain version compare value for value (tests/test_semi2.py:160-180
    canonicalises the TPU kernel's the same way): the window rows, ainit,
    band slots and k02 of pairs that skip phase 2 (done, or escaping with
    overflow2), the end finder's columns where it found nothing, term_cell
    of pairs not done (JAX reads the cell at score 0 there, K3 writes 0),
    and the aux_old rows above a done pair's final_s."""
    m1 = ex["meta1"].clone()
    done = m1[:, M1_DONE] > 0
    live = ~done & (m1[:, M1_OVF] == 0)
    m1[m1[:, M1_EFOUND] == 0, M1_ES:M1_ECELL + 1] = 0
    m1[~done, M1_TERM] = 0
    m1[~live, M1_K02] = 0
    out = {"meta1": m1}
    for key in ("win_m", "win_i", "win_d", "ainit"):
        out[key] = torch.where(live[None, :, None], ex[key], 0)
    for key in ("b_m", "b_ie"):
        out[key] = torch.where(live[None, :], ex[key], 0)
    aux_old = ex["aux_old"]
    rows = torch.arange(aux_old.shape[1], device=aux_old.device)[:, None]
    keep = ~done[None, :] | (rows <= m1[:, M1_FS][None, :])  # [S0, B]
    out["aux_old"] = torch.where(keep[None, :, :, None], aux_old, 0)
    return out


def canonical_resume(res, S0: int):
    """Phase 2's results (``kernel_engine.run_resume``) with the aux rows
    it leaves unspecified zeroed: all rows of pairs that did not finish in
    phase 2, and rows above final_s of those that did."""
    final_s, done, overflow, term_cell, aux2, end = res
    ran = done & ~overflow & (final_s >= S0)
    rows = torch.arange(aux2.shape[1], device=aux2.device)[:, None]
    keep = ran[None, :] & (rows <= (final_s - S0)[None, :])  # [S - S0, B]
    return (final_s, done, overflow, term_cell,
            torch.where(keep[None, :, :, None], aux2, 0), end)


def prefix_export(seq, lens, *, cfg: EngineConfig, Lq: int, Ltb: int,
                  S0: int, K2: int, packed: bool) -> dict:
    """Phase 1 of an uploaded batch (the port of
    ``wfa_tpu.semi2.prefix_export2``): ``seq`` is the query and target
    byte matrices side by side (2-bit packed when ``packed``), ``lens``
    int32[B, 3] (qlen, tlen, toff).  K3 for CUDA tensors, its plain
    version for CPU ones (``kernel_engine.run_prefix``); returns
    :func:`prefix_export_plain`'s dict."""
    from .kernel_engine import run_prefix

    qw = Lq // 4 if packed else Lq
    qb, tbuf = seq[:, :qw], seq[:, qw:]
    qlen, tlen, toff = (lens[:, i].contiguous() for i in range(3))
    if packed:
        qb = _unpack2(qb, Lq, torch.zeros_like(qlen), qlen)
        tbuf = _unpack2(tbuf, Ltb, toff, toff + tlen)
    return run_prefix(qb.contiguous(), tbuf.contiguous(), qlen, tlen, toff,
                      cfg=cfg, Lq=Lq, Ltb=Ltb, S0=S0, K2=K2)


def replace_targets(targets: Sequence[bytes], k02: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Re-place each target for its narrow window (the host mid-point of
    ``wfa_tpu.engine.BatchAligner._submit_semi2``, engine.py:1843-1867):
    buffer column c holds target position c - toff2 with toff2 = -k02, so
    a window past diagonal 0 (k02 > 0) keeps only the target's suffix
    from k02 on.  Returns (t2raw uint8[B, Ltb2], t2p 2-bit pack or None,
    toff2 int32[B], Ltb2), Ltb2 a 512-multiple as JAX's."""
    k02 = np.asarray(k02, np.int32)
    toff2 = -k02
    t_eff = [t[int(k):] if int(k) > 0 else t for t, k in zip(targets, k02)]
    tlen2 = np.fromiter((len(t) for t in t_eff), np.int32, len(t_eff))
    off_eff = np.maximum(toff2, 0).astype(np.int32)
    Ltb2 = max(int((off_eff + tlen2).max()), 1)
    Ltb2 = _pad_len(((Ltb2 + 511) // 512) * 512)
    if native.load() is not None:
        t2raw, t2p = native.build_and_pack(t_eff, tlen2, off_eff, Ltb2)
    else:
        pad = b"\0" * (Ltb2 + 1)
        t2raw = np.frombuffer(
            b"".join((pad[:int(o)] + t)[:Ltb2].ljust(Ltb2, b"\0")
                     for t, o in zip(t_eff, off_eff)),
            np.uint8).reshape(len(t_eff), Ltb2)
        t2p = _pack2(t2raw, off_eff, off_eff + tlen2)
    return t2raw, t2p, toff2.astype(np.int32), Ltb2


def phase2(seq2, lens2, win_m, win_i, win_d, ainit, b_m, b_ie, meta1,
           aux_old, *, cfg: EngineConfig, Lq: int, Ltb_full: int, Ltb2: int,
           S0: int, packed: bool) -> dict:
    """Narrow resume (K4), dual-aux backtrace (K2) and output packing, the
    port of ``wfa_tpu.semi2._phase2_impl``'s flat outputs.

    ``cfg`` is the phase-2 config (k_win the narrow window, s_cap the
    total score cap).  ``seq2`` holds the query and the re-placed target
    (:func:`replace_targets`), ``lens2`` int32[B, 3] (qlen, tlen, toff2).
    ``Ltb_full`` (the phase-1 buffer length) sets the token plan and the
    cell width of phase 2's aux; Ltb2 bounds only buffer columns.  Returns
    ``engine._finish_outputs``' dict (semi-global: full token streams)
    plus ``"final_s"``, the score each pair ran to."""
    from .kernel_engine import run_resume

    qw = Lq // 4 if packed else Lq
    qb, tb2 = seq2[:, :qw], seq2[:, qw:]
    qlen, tlen, toff2 = (lens2[:, i].contiguous() for i in range(3))
    if packed:
        qb = _unpack2(qb, Lq, torch.zeros_like(qlen), qlen)
        tb2 = _unpack2(tb2, Ltb2, toff2.clamp(min=0), toff2 + tlen)
    final_s, done, overflow, _, aux2, (end_s, end_k, end_cell) = run_resume(
        qb.contiguous(), tb2.contiguous(), qlen, tlen, toff2, win_m, win_i,
        win_d, ainit, b_m, b_ie, meta1, cfg=cfg, Lq=Lq, Ltb2=Ltb2,
        Ltb_full=Ltb_full, S0=S0)
    out = _finish_outputs(
        aux2, end_cell, -toff2, end_s, end_k, qlen, tlen, done, overflow,
        cfg=cfg, Lq=Lq, Ltb=Ltb_full, edit=False, aux_old=aux_old,
        k0_old=-(qlen - 1), s_split=S0)
    out["final_s"] = final_s
    return out
