"""Kernel K1: the per-pair CUDA score loop (``csrc/score_loop.cu``).

The port of the TPU kernel ``wfa_tpu.pallas_engine._kernel`` as
``pallas_run_batch`` reaches it, in global mode and in semi-global mode
with its fused end finder.  Its plain PyTorch version is
:func:`wfa_tpu_torch.engine.run_batch_plain`, which this wrapper runs for
CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .engine import EngineConfig, run_batch_plain


def scratch_ints(cfg: EngineConfig) -> int:
    """int32 cells of window scratch per pair: WM rows of M and WE rows
    each of I and D, K diagonals wide."""
    p = cfg.penalties
    wm = max(p.mismatch, p.gap_open + p.gap_ext) + 1
    return (wm + 2 * (p.gap_ext + 1)) * cfg.k_win


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
    from ._build import check_inputs, launch, stream_ptr

    B = qb.shape[0]
    S, K = cfg.s_cap, cfg.k_win
    p = cfg.penalties
    i32 = torch.int32
    dev = qb.device
    check_inputs("run_batch", dev, qb=(qb, torch.uint8, (B, Lq)),
                 tbuf=(tbuf, torch.uint8, (B, Ltb)), qlen=(qlen, i32, (B,)),
                 tlen=(tlen, i32, (B,)), toff=(toff, i32, (B,)))
    win = torch.empty((B, scratch_ints(cfg)), dtype=i32, device=dev)
    out = torch.empty((7, B), dtype=i32, device=dev)
    aux = torch.empty((3, S, B, K), dtype=i32, device=dev)
    ad = cfg.adaptive
    launch("wfa_score_loop", qb, tbuf, qlen, tlen, toff,
           *(ctypes.c_int(v) for v in (
               B, Lq, Ltb, S, K, p.mismatch, p.gap_open + p.gap_ext,
               p.gap_ext, int(ad is not None),
               ad.min_wf_len if ad else 0, ad.max_dist_diff if ad else 0,
               int(not cfg.global_alignment))),
           win, out, aux, stream_ptr(dev))
    run_batch.launches["global" if cfg.global_alignment else "semi"] += 1
    return (out[0], out[1] > 0, out[2] > 0, out[3], aux,
            (out[4], out[5], out[6]))


# launches per instantiation of the kernel (global, semi-global)
run_batch.launches = {"global": 0, "semi": 0}
