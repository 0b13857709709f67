"""Kernel K1: the per-pair CUDA score loop (``csrc/score_loop.cu``).

The port of the TPU kernel ``wfa_tpu.pallas_engine._kernel`` as
``pallas_run_batch`` reaches it, in global mode and in semi-global mode
with its fused end finder (:func:`run_batch`; plain version
:func:`wfa_tpu_torch.engine.run_batch_plain`), and of the long-read TPU
kernel ``wfa_tpu.pallas_longread._kernel`` (:func:`run_batch_long`, K1's
value-rebased int16 aux mode; plain version
:func:`wfa_tpu_torch.engine.run_batch_long_plain`), and of
``pallas_engine._kernel`` with ``aux_kw`` (:func:`run_batch_kw`, K1-kw:
K1-long's staging with a KW-column row window and ``sbase`` words; plain
version :func:`wfa_tpu_torch.engine.run_batch_kw_plain`; it runs the
warp shape, one warp a pair and several pairs a block, launched by
:func:`warp_plan`).  The two
phases of the two-phase semi-global route are the same kernel's prefix and
resume modes: K3 (:func:`run_prefix`, the port of ``wfa_tpu.pallas_prefix
._kernel`` and of ``pallas_engine._kernel`` in EXPORT mode; plain version
:func:`wfa_tpu_torch.semi2.prefix_export_plain`) and K4
(:func:`run_resume`, ``pallas_engine._kernel`` with RESUME; plain version
:func:`wfa_tpu_torch.engine.run_batch_resume_plain`; the warp shape too,
by :func:`warp_plan`).  Each wrapper runs
its plain version for CPU tensors and launches its kernel, or raises, for
CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._build import count
from .engine import (EngineConfig, check_aux_kw, run_batch_kw_plain,
                     run_batch_long_plain, run_batch_plain,
                     run_batch_resume_plain, semi_cell16, windows)
from .semi2 import META1_COLS, prefix_export_plain


# shared memory a launch gets without a function attribute (the kernel's
# kSharedBytes), and what K3 raises its limit to: what a Hopper block may
# have (kSharedOptIn)
SHARED_BYTES = 48 * 1024
SHARED_OPTIN = 227 * 1024
# shared memory an H100 SM holds, and what each resident block takes of it
# beside its own
SM_SHARED = 228 * 1024
BLOCK_RESERVED = 1024
# the block_min slots of a block's shared memory, ahead of the band slots
# (the kernel's red_ints): eight for each warp of a pair, four warps but
# in K3 and the warp shape (none there); K3's workspace placement counts
# the slots of a 512-thread block, the widest that holds its workspace in
# shared memory (the kernel's kPrefixSharedWarps)
RED_INTS_A_WARP = 8
WARPS = 4
PREFIX_SHARED_WARPS = 16
# staged aux rows of the score loop's C modes (0 global, 1 semi-global, 2
# long-read, 3 KW, "kw16" KW with 16-bit cells) and of K3 (int32 cells, or
# "prefix16" int16) / K4 ("resume16": int16) (the kernel's stage_rows):
# the long-read and KW modes stage the two newest rows of each plane, K3
# its aux row S0
STAGE_ROWS = {0: 0, 1: 0, 2: 6, 3: 6, "kw16": 6, "prefix": 3, "prefix16": 3,
              "resume": 0, "resume16": 0}
# the mode argument of the C entry wfa_workspace for each key of STAGE_ROWS
# (wfa_score_loop takes 0-3 and 8)
C_MODES = {0: 0, 1: 1, 2: 2, 3: 3, "prefix": 4, "resume": 5, "prefix16": 6,
           "resume16": 7, "kw16": 8}
# K3's modes: its windows and staged row hold its aux cells
PREFIX_MODES = ("prefix", "prefix16")
# the modes whose window (and staged) cells are 16-bit
CELL16_MODES = ("prefix16", "resume16", "kw16")
# the warp shape's modes, K1-kw and K4 (one warp a pair, several pairs a
# block, no ballot words; K4's windows hold its aux cells), the most pairs
# a block (the kernel's kWarpPairs), and the pairs a block every plan of
# every_warp_plan tries
KW_MODES = (3, "kw16")
RESUME_MODES = ("resume", "resume16")
WARP_MODES = KW_MODES + RESUME_MODES
WARP_PAIRS = 16
WARP_SHAPES = (1, 2, 4, 8, 16)
# K1-kw keeps its workspace in the scratch (cached near the SM) while each
# SM gets at most this many pairs, in shared memory past it where it fits
# (PERF.md §6)
KW_SCRATCH_PAIRS = 8
# K1-kw's 16-bit cells hold every offset of a target buffer of this many
# columns or fewer (the kernel's kMaxLtb16)
KW_CELL16_LTB = 8189


def kw_mode(Ltb: int):
    """K1-kw's workspace mode: 16-bit window and staged cells ("kw16")
    where every offset of a target buffer of ``Ltb`` columns fits them
    ((Ltb + 2) << 3 | 7 below 2**16), else int32 (3)."""
    return "kw16" if Ltb <= KW_CELL16_LTB else 3


def resume_mode(Ltb_full: int) -> str:
    """K4's workspace mode in the warp shape: int16 window cells where its
    aux cells are."""
    return "resume16" if semi_cell16(Ltb_full) else "resume"


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def slot_ints(cfg: EngineConfig, warps: int = WARPS) -> int:
    """Shared ints of a block ahead of its workspace at ``warps`` warps a
    pair: the reduction slots (``RED_INTS_A_WARP`` a warp) and the band
    slots (3 WM + 6 WE), rounded up to a multiple of 4 (the kernel's
    slot_ints)."""
    wm, we = windows(cfg.penalties)
    return _round4(RED_INTS_A_WARP * warps + 3 * wm + 6 * we)


def warp_slot_ints(cfg: EngineConfig) -> int:
    """The warp shape's shared ints for each pair ahead of its workspace:
    its band slots (3 WM + 6 WE), rounded up to a multiple of 4 (the
    kernel's warp_slot_ints)."""
    wm, we = windows(cfg.penalties)
    return _round4(3 * wm + 6 * we)


def workspace(cfg: EngineConfig, mode) -> tuple:
    """(ints, shared): the int32 cells of one pair's score-loop workspace
    in ``mode`` (a key of ``STAGE_ROWS``): WM rows of M and WE rows each
    of I and D, ``cfg.k_win`` diagonals wide, the staged aux rows (int32
    cells; 16-bit ones in ``CELL16_MODES``, filling whole 16-byte words),
    three ballot words for every 32 columns (none in the warp shape,
    ``WARP_MODES``), rounded up to a multiple of 4; and
    whether it fits the block's shared memory after the slots
    (:func:`slot_ints`): ``SHARED_BYTES``, or K3's ``SHARED_OPTIN`` with
    the slots of ``PREFIX_SHARED_WARPS``, or in the warp shape one pair's
    slots and workspace in ``SHARED_OPTIN``.  The launch passes a device
    scratch of ``ints`` a pair where it does not (K3 and the warp shape:
    where the launch plan puts it, :func:`prefix_plan`,
    :func:`warp_plan`).  The kernel's C entry ``wfa_workspace`` gives the
    same pair from the layout the kernel uses
    (``tests/test_torch_cuda.py`` holds the two together); a launch whose
    shared memory would pass the limit is refused."""
    wm, we = windows(cfg.penalties)
    K = cfg.k_win
    cells = (wm + 2 * we + STAGE_ROWS[mode]) * K
    if mode in CELL16_MODES:
        cells = (cells * 2 + 15) // 16 * 4
    warp = mode in WARP_MODES
    ints = _round4(cells + (0 if warp else 3 * ((K + 31) // 32)))
    if warp:
        slots, limit = warp_slot_ints(cfg), SHARED_OPTIN
    elif mode in PREFIX_MODES:
        slots, limit = slot_ints(cfg, PREFIX_SHARED_WARPS), SHARED_OPTIN
    else:
        slots, limit = slot_ints(cfg), SHARED_BYTES
    return ints, 4 * (slots + ints) <= limit


def _scratch(cfg: EngineConfig, mode, B: int, dev):
    """The launch's device scratch, or None when the workspace goes to
    shared memory."""
    ints, shared = workspace(cfg, mode)
    if shared:
        return None
    return torch.empty((B, ints), dtype=torch.int32, device=dev)


class WarpPlan(NamedTuple):
    """The launch of K1-kw or K4 at one shape: pairs (warps) a block; the
    dynamic shared memory bytes a block asks for, whether each pair's
    workspace goes to a device scratch (else to that shared memory), and
    its int32 cells."""
    pairs: int
    shared_bytes: int
    scratch: bool
    ints: int


def warp_plan(cfg: EngineConfig, mode, B: int, sms: int, pairs=None,
              scratch=None) -> WarpPlan:
    """The launch plan of K1-kw or K4 in ``mode`` (a key of
    ``WARP_MODES``) for ``B`` pairs at window ``cfg.k_win`` on a card of
    ``sms`` SMs, unless ``pairs`` and ``scratch`` are given: as many pairs
    a block as each SM gets, up to ``WARP_PAIRS``, whose registers the
    kernel keeps; the workspace in shared memory where an SM holds that
    many pairs' workspaces there (with each block's reserve) and, for
    K1-kw, each SM gets more than ``KW_SCRATCH_PAIRS``; else in the
    scratch.  Timed in turns at l=1000 and l=4000 (PERF.md §6).  The C
    entry ``wfa_warp_shared`` computes the same shared bytes."""
    per_sm = min(WARP_PAIRS, -(-B // sms))
    if pairs is None:
        pairs = per_sm
    ints, _ = workspace(cfg, mode)
    per_pair = 4 * (warp_slot_ints(cfg) + ints)
    if scratch is None:
        block = pairs * per_pair
        held = (pairs * (SM_SHARED // (block + BLOCK_RESERVED))
                if block <= SHARED_OPTIN else 0)
        scratch = held < per_sm or (mode in KW_MODES
                                    and per_sm <= KW_SCRATCH_PAIRS)
    shared = 4 * pairs * (warp_slot_ints(cfg) + (0 if scratch else ints))
    return WarpPlan(pairs, shared, scratch, ints)


def every_warp_plan(cfg: EngineConfig, mode, B: int, sms: int) -> list:
    """Every launch plan K1-kw or K4 takes for ``B`` pairs in ``mode``:
    each of ``WARP_SHAPES`` pairs a block and the plan's own with the
    workspace in the device scratch and, where a block holds them, in
    shared memory."""
    plans = []
    own = warp_plan(cfg, mode, B, sms).pairs
    for n in sorted(set(WARP_SHAPES) | {own}):
        for scratch in (True, False):
            plan = warp_plan(cfg, mode, B, sms, n, scratch)
            if scratch or plan.shared_bytes <= SHARED_OPTIN:
                plans.append(plan)
    return plans


def loop_args(qb, tbuf, qlen, tlen, toff, cfg: EngineConfig, Lq: int,
              Ltb: int, mode: int, aux, aux_base, kw: int = 0, plan=None):
    """Check the inputs of ``wfa_score_loop`` in ``mode`` (0 global, 1
    semi-global, 2 long-read, 3 KW with ``kw`` columns and ``aux_base``
    the sbase words, launched at ``plan``, default :func:`warp_plan`'s,
    with 16-bit cells where :func:`kw_mode` takes them, C mode 8);
    returns (its arguments up to the stream, the out rows int32[7, B]
    they write)."""
    from ._build import check_inputs

    B = qb.shape[0]
    p = cfg.penalties
    i32 = torch.int32
    dev = qb.device
    check_inputs("run_batch", dev, qb=(qb, torch.uint8, (B, Lq)),
                 tbuf=(tbuf, torch.uint8, (B, Ltb)), qlen=(qlen, i32, (B,)),
                 tlen=(tlen, i32, (B,)), toff=(toff, i32, (B,)))
    out = torch.empty((7, B), dtype=i32, device=dev)
    if mode == 3:
        key = kw_mode(Ltb)
        mode = C_MODES[key]
        plan = plan or warp_plan(cfg, key, B, _sms(dev))
        pairs, win = plan.pairs, (torch.empty(
            (B, plan.ints), dtype=i32, device=dev) if plan.scratch else None)
    else:
        pairs, win = 0, _scratch(cfg, mode, B, dev)
    ad = cfg.adaptive
    return (qb, tbuf, qlen, tlen, toff,
            *(ctypes.c_int(v) for v in (
                B, Lq, Ltb, cfg.s_cap, cfg.k_win, p.mismatch,
                p.gap_open + p.gap_ext, p.gap_ext, int(ad is not None),
                ad.min_wf_len if ad else 0, ad.max_dist_diff if ad else 0,
                mode, kw, pairs)),
            win, out, aux, aux_base), out


def _launch(qb, tbuf, qlen, tlen, toff, cfg: EngineConfig, Lq: int,
            Ltb: int, mode: int, aux, aux_base, kw: int = 0, plan=None):
    """Check the inputs and launch ``wfa_score_loop`` in ``mode``
    (:func:`loop_args`) on the current stream; returns the out rows
    int32[7, B]."""
    from ._build import launch, stream_ptr

    args, out = loop_args(qb, tbuf, qlen, tlen, toff, cfg, Lq, Ltb, mode,
                          aux, aux_base, kw, plan)
    launch("wfa_score_loop", *args, stream_ptr(qb.device))
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
    count(run_batch.launches, "global" if cfg.global_alignment else "semi")
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
    count(run_batch_long.launches, "long")
    return out[0], out[1] > 0, out[2] > 0, out[3], aux, aux_base


# launches of the long-read instantiation
run_batch_long.launches = {"long": 0}


def run_batch_kw(qb, tbuf, qlen, tlen, toff, *, cfg: EngineConfig, Lq: int,
                 Ltb: int):
    """K1-kw, the score loop with row- and value-rebased aux of
    ``cfg.aux_kw`` columns (global alignment only): returns
    (final_s int32[B], done bool[B], overflow bool[B], term_cell int32[B],
    aux int16[3, S, B, KW], sbase int32[S, B]), the contract of
    :func:`run_batch_kw_plain`.  Aux rows and sbase words above a pair's
    final_s, and those of a pair not served, are unspecified.  Raises
    ValueError for a KW the TPU kernel refuses (``check_aux_kw``).

    CUDA tensors launch ``wfa_score_loop`` in its KW mode on the current
    stream; CPU tensors take :func:`run_batch_kw_plain`."""
    if qb.device.type == "cpu":
        return run_batch_kw_plain(qb, tbuf, qlen, tlen, toff, cfg=cfg, Lq=Lq,
                                  Ltb=Ltb)
    res = _kw_launch(qb, tbuf, qlen, tlen, toff, cfg=cfg, Lq=Lq, Ltb=Ltb)
    count(run_batch_kw.launches, "kw")
    return res


def _kw_launch(qb, tbuf, qlen, tlen, toff, *, cfg: EngineConfig, Lq: int,
               Ltb: int, plan=None):
    """Launch K1-kw at ``plan`` (default :func:`warp_plan`'s for the card)
    on the current stream; returns :func:`run_batch_kw`'s tuple.  Counts
    no launch."""
    KW = check_aux_kw(cfg, Ltb)
    B, S = qb.shape[0], cfg.s_cap
    aux = torch.empty((3, S, B, KW), dtype=torch.int16, device=qb.device)
    sbase = torch.empty((S, B), dtype=torch.int32, device=qb.device)
    out = _launch(qb, tbuf, qlen, tlen, toff, cfg, Lq, Ltb, 3, aux, sbase,
                  kw=KW, plan=plan)
    return out[0], out[1] > 0, out[2] > 0, out[3], aux, sbase


# launches of the KW instantiation
run_batch_kw.launches = {"kw": 0}


class PrefixPlan(NamedTuple):
    """K3's launch at one shape: threads a block, the dynamic shared
    memory bytes a block asks for, whether each pair's workspace goes to a
    device scratch (else to that shared memory), its int32 cells, and the
    blocks of a pair (a thread-block cluster; the scratch only)."""
    threads: int
    shared_bytes: int
    scratch: bool
    ints: int
    cluster: int = 1


# K3's launch shapes built (the kernel's prefix_shape): (threads a block,
# blocks a pair, a thread-block cluster over the scratch)
PREFIX_SHAPES = ((256, 1), (512, 1), (1024, 1), (1024, 2))
# columns of span for each pair an SM up to which one 1024-thread block a
# pair beats 256-thread blocks in the scratch (prefix_block_shape)
PREFIX_WIDE_COLUMNS = 2048


def prefix_block_shape(Kf: int, B: int, scratch: bool, sms: int) -> tuple:
    """K3's block shape (threads a block, blocks a pair) for ``B`` pairs
    at the full span ``Kf`` on a card of ``sms`` SMs, by where the
    workspace lies and the pairs each SM gets.  Pairs that share an SM
    fill it with 256-thread blocks; fewer need more threads a pair to keep
    loads in flight on the wide steps: in shared memory 512 up to a pair
    an SM; in the scratch a thread-block cluster of two 1024-thread blocks
    where every pair's two fit the card at once, else one 1024-thread
    block while an SM gets at most a pair for every
    ``PREFIX_WIDE_COLUMNS`` columns of span (the wide steps' work grows
    with it).  Timed in turns at Kf 2048, 4224 and 20,096 (PERF.md §6)."""
    if not scratch:
        return (512, 1) if B <= sms else (256, 1)
    if 2 * B <= sms:
        return (1024, 2)
    if B * PREFIX_WIDE_COLUMNS <= sms * Kf:
        return (1024, 1)
    return (256, 1)


# the SMs of the card the CPU tests plan for (an H100 SXM's)
H100_SMS = 132


def prefix_plan(cfg: EngineConfig, B: int, cell16: bool, sms: int,
                threads=None, scratch=None, cluster=None) -> PrefixPlan:
    """K3's launch plan for ``B`` pairs at the full span ``cfg.k_win`` on
    a card of ``sms`` SMs: the workspace's place, the block shape
    (:func:`prefix_block_shape`), unless given, and the shared memory they
    ask for (the C entry ``wfa_prefix_shared`` computes the same).  The workspace
    goes to shared memory where two blocks fit an SM (int16 cells up to Kf
    3072 at 4/6/2: three blocks an SM at Kf 2048); one block alone an SM
    lost to the scratch (PERF.md §6)."""
    mode = "prefix16" if cell16 else "prefix"
    ints, fits = workspace(cfg, mode)
    if scratch is None:
        per_block = (4 * (slot_ints(cfg, PREFIX_SHARED_WARPS) + ints)
                     + BLOCK_RESERVED)
        scratch = not fits or 2 * per_block > SM_SHARED
    if threads is None:
        threads, shape_cluster = prefix_block_shape(cfg.k_win, B, scratch,
                                                    sms)
        cluster = cluster or shape_cluster
    cluster = cluster or 1
    wm, we = windows(cfg.penalties)
    warps = threads * cluster // 32
    shared = (4 * (RED_INTS_A_WARP * warps + 3 * wm + 6 * we) if scratch
              else 4 * (slot_ints(cfg, warps) + ints))
    return PrefixPlan(threads, shared, scratch, ints, cluster)


def every_prefix_plan(cfg: EngineConfig, B: int, cell16: bool,
                      sms: int) -> list:
    """Every launch plan K3 takes for ``B`` pairs at the full span
    ``cfg.k_win``: each block shape of ``PREFIX_SHAPES`` with its
    workspace in the device scratch and, for one block a pair where the
    plan's shared memory fits a block, in shared memory."""
    plans = []
    for t, cl in PREFIX_SHAPES:
        for scratch in (True, False) if cl == 1 else (True,):
            plan = prefix_plan(cfg, B, cell16, sms, t, scratch, cl)
            if scratch or plan.shared_bytes <= SHARED_OPTIN:
                plans.append(plan)
    return plans


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _prefix_launch(qb, tbuf, qlen, tlen, toff, *, cfg: EngineConfig,
                   Lq: int, Ltb: int, S0: int, K2: int, plan=None,
                   cycles=None) -> dict:
    """Check the inputs and launch ``wfa_prefix`` with ``plan`` (default
    :func:`prefix_plan`'s for the card) on the current stream (its TIMED
    instantiation when ``cycles`` is given); returns the exports.  Counts
    no launch."""
    from ._build import check_inputs, launch, stream_ptr

    B, Kf = qb.shape[0], cfg.k_win
    wm, we = windows(cfg.penalties)
    if S0 < wm:
        raise ValueError(f"run_prefix: S0 {S0} below the window depth {wm}")
    i32, dev = torch.int32, qb.device
    check_inputs("run_prefix", dev, qb=(qb, torch.uint8, (B, Lq)),
                 tbuf=(tbuf, torch.uint8, (B, Ltb)), qlen=(qlen, i32, (B,)),
                 tlen=(tlen, i32, (B,)), toff=(toff, i32, (B,)))
    cell16 = semi_cell16(Ltb)
    if plan is None:
        plan = prefix_plan(cfg, B, cell16, _sms(dev))
    ex = {"win_m": torch.empty((wm, B, K2), dtype=i32, device=dev),
          "win_i": torch.empty((we, B, K2), dtype=i32, device=dev),
          "win_d": torch.empty((we, B, K2), dtype=i32, device=dev),
          "ainit": torch.empty((3, B, K2), dtype=i32, device=dev),
          "b_m": torch.empty((3 * wm, B), dtype=i32, device=dev),
          "b_ie": torch.empty((6 * we, B), dtype=i32, device=dev),
          "meta1": torch.empty((B, len(META1_COLS)), dtype=i32, device=dev),
          "aux_old": torch.empty((3, S0, B, Kf), device=dev,
                                 dtype=torch.int16 if cell16 else i32)}
    win = (torch.empty((B, plan.ints), dtype=i32, device=dev)
           if plan.scratch else None)
    p, ad = cfg.penalties, cfg.adaptive
    launch("wfa_prefix", qb, tbuf, qlen, tlen, toff,
           *(ctypes.c_int(v) for v in (
               B, Lq, Ltb, S0, Kf, K2, p.mismatch, p.gap_open + p.gap_ext,
               p.gap_ext, int(ad is not None), ad.min_wf_len if ad else 0,
               ad.max_dist_diff if ad else 0, int(cell16), plan.threads,
               plan.cluster)),
           win, ex["aux_old"], *(ex[k] for k in (
               "win_m", "win_i", "win_d", "ainit", "b_m", "b_ie", "meta1")),
           cycles, stream_ptr(dev))
    return ex


def run_prefix(qb, tbuf, qlen, tlen, toff, *, cfg: EngineConfig, Lq: int,
               Ltb: int, S0: int, K2: int) -> dict:
    """K3, phase 1 of the two-phase semi-global route: scores 0 .. S0 - 1
    at the full span ``cfg.k_win`` and the handoff to a narrow window of
    K2 diagonals; returns the dict of
    :func:`wfa_tpu_torch.semi2.prefix_export_plain` (JAX layouts).
    Exports of pairs done or escaped at S0 are unspecified, and so are
    aux_old rows above a done pair's final_s.

    CUDA tensors launch ``wfa_prefix`` on the current stream; CPU tensors
    take :func:`prefix_export_plain`."""
    if qb.device.type == "cpu":
        return prefix_export_plain(qb, tbuf, qlen, tlen, toff, cfg=cfg,
                                   Lq=Lq, Ltb=Ltb, S0=S0, K2=K2)
    ex = _prefix_launch(qb, tbuf, qlen, tlen, toff, cfg=cfg, Lq=Lq, Ltb=Ltb,
                        S0=S0, K2=K2)
    count(run_prefix.launches, "prefix")
    return ex


# launches of the prefix mode
run_prefix.launches = {"prefix": 0}


def run_resume(qb, tbuf2, qlen, tlen, toff2, win_m, win_i, win_d, ainit,
               b_m, b_ie, meta1, *, cfg: EngineConfig, Lq: int, Ltb2: int,
               Ltb_full: int, S0: int):
    """K4, phase 2 of the two-phase semi-global route: resumes at score S0
    from the phase-1 exports in the narrow window (origin -toff2, width
    ``cfg.k_win``) up to ``cfg.s_cap``; returns (final_s, done, overflow,
    term_cell, aux2 [3, s_cap - S0, B, K], (end_s, end_k, end_cell)), the
    contract of :func:`run_batch_resume_plain`.  Aux rows above a pair's
    final_s, and every row of a pair that did not run in phase 2, are
    unspecified.

    CUDA tensors launch ``wfa_resume`` on the current stream; CPU tensors
    take :func:`run_batch_resume_plain`."""
    args = (qb, tbuf2, qlen, tlen, toff2, win_m, win_i, win_d, ainit, b_m,
            b_ie, meta1)
    kw = dict(cfg=cfg, Lq=Lq, Ltb2=Ltb2, Ltb_full=Ltb_full, S0=S0)
    if qb.device.type == "cpu":
        return run_batch_resume_plain(*args, **kw)
    res = _resume_launch(*args, **kw)
    count(run_resume.launches, "resume")
    return res


def _resume_launch(qb, tbuf2, qlen, tlen, toff2, win_m, win_i, win_d, ainit,
                   b_m, b_ie, meta1, *, cfg: EngineConfig, Lq: int,
                   Ltb2: int, Ltb_full: int, S0: int, plan=None,
                   cycles=None):
    """Check the inputs and launch ``wfa_resume`` at ``plan`` (default
    :func:`warp_plan`'s for the card) on the current stream (its TIMED
    instantiation when ``cycles`` is given); returns :func:`run_resume`'s
    tuple.  Counts no launch."""
    from ._build import check_inputs, launch, stream_ptr

    B, S, K = qb.shape[0], cfg.s_cap, cfg.k_win
    wm, we = windows(cfg.penalties)
    if not wm <= S0 < S:
        raise ValueError(f"run_resume: S0 {S0} outside [{wm}, {S})")
    i32, dev = torch.int32, qb.device
    check_inputs("run_resume", dev, qb=(qb, torch.uint8, (B, Lq)),
                 tbuf2=(tbuf2, torch.uint8, (B, Ltb2)),
                 qlen=(qlen, i32, (B,)), tlen=(tlen, i32, (B,)),
                 toff2=(toff2, i32, (B,)), win_m=(win_m, i32, (wm, B, K)),
                 win_i=(win_i, i32, (we, B, K)),
                 win_d=(win_d, i32, (we, B, K)),
                 ainit=(ainit, i32, (3, B, K)), b_m=(b_m, i32, (3 * wm, B)),
                 b_ie=(b_ie, i32, (6 * we, B)),
                 meta1=(meta1, i32, (B, len(META1_COLS))))
    cell16 = semi_cell16(Ltb_full)
    if plan is None:
        plan = warp_plan(cfg, resume_mode(Ltb_full), B, _sms(dev))
    aux2 = torch.empty((3, S - S0, B, K), device=dev,
                       dtype=torch.int16 if cell16 else i32)
    win = (torch.empty((B, plan.ints), dtype=i32, device=dev)
           if plan.scratch else None)
    out = torch.empty((7, B), dtype=i32, device=dev)
    p, ad = cfg.penalties, cfg.adaptive
    launch("wfa_resume", qb, tbuf2, qlen, tlen, toff2,
           *(ctypes.c_int(v) for v in (
               B, Lq, Ltb2, S, S0, K, p.mismatch, p.gap_open + p.gap_ext,
               p.gap_ext, int(ad is not None), ad.min_wf_len if ad else 0,
               ad.max_dist_diff if ad else 0, int(cell16), plan.pairs)),
           win, out, aux2, win_m, win_i, win_d, ainit, b_m, b_ie, meta1,
           cycles, stream_ptr(dev))
    return (out[0], out[1] > 0, out[2] > 0, out[3], aux2,
            (out[4], out[5], out[6]))


# launches of the resume mode
run_resume.launches = {"resume": 0}
