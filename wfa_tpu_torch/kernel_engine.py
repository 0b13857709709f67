"""Kernel K1: the per-pair CUDA score loop (``csrc/score_loop.cu``).

The port of the TPU kernel ``wfa_tpu.pallas_engine._kernel`` as
``pallas_run_batch`` reaches it, in global mode and in semi-global mode
with its fused end finder (:func:`run_batch`; plain version
:func:`wfa_tpu_torch.engine.run_batch_plain`), and of the long-read TPU
kernel ``wfa_tpu.pallas_longread._kernel`` (:func:`run_batch_long`, K1's
value-rebased int16 aux mode; plain version
:func:`wfa_tpu_torch.engine.run_batch_long_plain`).  Each wrapper runs its
plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .engine import EngineConfig, run_batch_long_plain, run_batch_plain


def scratch_ints(cfg: EngineConfig, rebase: bool = False) -> int:
    """int32 cells of window scratch per pair: WM rows of M and WE rows
    each of I and D, K diagonals wide, plus the three staged aux rows of
    the long-read (``rebase``) mode."""
    p = cfg.penalties
    wm = max(p.mismatch, p.gap_open + p.gap_ext) + 1
    return (wm + 2 * (p.gap_ext + 1) + (3 if rebase else 0)) * cfg.k_win


def _launch(qb, tbuf, qlen, tlen, toff, cfg: EngineConfig, Lq: int,
            Ltb: int, mode: int, aux, aux_base):
    """Check the inputs and launch ``wfa_score_loop`` in ``mode`` (0
    global, 1 semi-global, 2 long-read) on the current stream; returns
    the out rows int32[7, B]."""
    from ._build import check_inputs, launch, stream_ptr

    B = qb.shape[0]
    p = cfg.penalties
    i32 = torch.int32
    dev = qb.device
    check_inputs("run_batch", dev, qb=(qb, torch.uint8, (B, Lq)),
                 tbuf=(tbuf, torch.uint8, (B, Ltb)), qlen=(qlen, i32, (B,)),
                 tlen=(tlen, i32, (B,)), toff=(toff, i32, (B,)))
    win = torch.empty((B, scratch_ints(cfg, mode == 2)), dtype=i32,
                      device=dev)
    out = torch.empty((7, B), dtype=i32, device=dev)
    ad = cfg.adaptive
    launch("wfa_score_loop", qb, tbuf, qlen, tlen, toff,
           *(ctypes.c_int(v) for v in (
               B, Lq, Ltb, cfg.s_cap, cfg.k_win, p.mismatch,
               p.gap_open + p.gap_ext, p.gap_ext, int(ad is not None),
               ad.min_wf_len if ad else 0, ad.max_dist_diff if ad else 0,
               mode)),
           win, out, aux, aux_base, stream_ptr(dev))
    return out


def run_batch(qb, tbuf, qlen, tlen, toff, *, cfg: EngineConfig, Lq: int,
              Ltb: int):
    """Run the score loop for a batch; returns (final_s int32[B],
    done bool[B], overflow bool[B], term_cell int32[B],
    aux int32[3, S, B, K], (end_s, end_k, end_cell) int32[B] each), the
    contract of :func:`run_batch_plain`.  Aux rows above a pair's
    final_s, and every row of an overflow pair, are unspecified.

    CUDA tensors launch ``wfa_score_loop`` on the current stream; CPU
    tensors take :func:`run_batch_plain`."""
    if qb.device.type == "cpu":
        return run_batch_plain(qb, tbuf, qlen, tlen, toff, cfg=cfg, Lq=Lq,
                               Ltb=Ltb)
    B = qb.shape[0]
    aux = torch.empty((3, cfg.s_cap, B, cfg.k_win), dtype=torch.int32,
                      device=qb.device)
    out = _launch(qb, tbuf, qlen, tlen, toff, cfg, Lq, Ltb,
                  0 if cfg.global_alignment else 1, aux, None)
    run_batch.launches["global" if cfg.global_alignment else "semi"] += 1
    return (out[0], out[1] > 0, out[2] > 0, out[3], aux,
            (out[4], out[5], out[6]))


# launches per instantiation of the kernel (global, semi-global)
run_batch.launches = {"global": 0, "semi": 0}


def run_batch_long(qb, tbuf, qlen, tlen, toff, *, cfg: EngineConfig,
                   Lq: int, Ltb: int):
    """K1-long, the long-read score loop (global alignment only): returns
    (final_s int32[B], done bool[B], overflow bool[B], term_cell int32[B],
    aux int16[3, S, B, K], aux_base int32[B, S]), the contract of
    :func:`run_batch_long_plain`.  Aux rows and bases above a pair's
    final_s, and those of an overflow pair, are unspecified.

    CUDA tensors launch ``wfa_score_loop`` in its long-read mode on the
    current stream; CPU tensors take :func:`run_batch_long_plain`."""
    if not cfg.global_alignment:
        raise ValueError("run_batch_long: the long-read mode is global only")
    if qb.device.type == "cpu":
        return run_batch_long_plain(qb, tbuf, qlen, tlen, toff, cfg=cfg,
                                    Lq=Lq, Ltb=Ltb)
    B = qb.shape[0]
    S = cfg.s_cap
    aux = torch.empty((3, S, B, cfg.k_win), dtype=torch.int16,
                      device=qb.device)
    aux_base = torch.empty((B, S), dtype=torch.int32, device=qb.device)
    out = _launch(qb, tbuf, qlen, tlen, toff, cfg, Lq, Ltb, 2, aux, aux_base)
    run_batch_long.launches["long"] += 1
    return out[0], out[1] > 0, out[2] > 0, out[3], aux, aux_base


# launches of the long-read instantiation
run_batch_long.launches = {"long": 0}
