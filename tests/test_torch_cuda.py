"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels build
with nvcc at first use) and skip elsewhere.  ``tests/conftest.py``
imports JAX, which the card machine lacks, so run them there with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

``chip_smoke.py`` covers the main configurations at their full size;
these cover the other shapes the main path can give the kernels (tier-1
and tier-2 windows, no reduction, degenerate penalties, overflows, raw
bytes, semi-global full-span windows; K1-long and K2 over its rebased
aux at long-read lengths, the int16 guard and the raw outputs; K1-kw
and K2 over its sbase words at KW == k_win (l=4000, the pipeline's
route), at KW < k_win (the row window shifts) and where every pair
escapes; K3, K4 and K2 over both aux tensors of the two-phase semi-global
route at its tier-0 and tier-1 caps, at l=5000, at penalties the TPU's
chunked prefix kernel refuses, and with a target row that holds only a
suffix; the score loop's workspace in shared memory and in the device
scratch on either side of the limit, and its size and place against the
kernel's own layout; the warp shape of K1-kw and K4 on either side of
each threshold of its launch plan, at every plan on a batch whose pairs
leave one block at different steps; mismatch or gap extension 1; an
extension that ends at the last byte of the batch's rows; exact global
alignment at its full-span window and the exact cell's score caps, on
the batches its path builds; global paths at the penalties' stride
against the plain versions and the stride-1 launch), and that the card's
host packs the long-read cell's batch with the native pack's vector
body.  Integer outputs: exact equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

from wfa_tpu_torch import AdaptiveReductionOption, Penalties
from wfa_tpu_torch.datagen import generate_pairs

pytestmark = pytest.mark.cuda

ADAPTIVE = AdaptiveReductionOption(10, 50, 1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _pairs(n, length, err, seed, raw=False):
    pairs = generate_pairs(n, length, err, seed=seed)
    # length differences and a far-off terminal diagonal
    pairs[0] = (pairs[0][0], pairs[0][0][: length // 2])
    pairs[1] = (pairs[1][0][: length // 3], pairs[1][0])
    if raw:
        pairs[2] = (b"NNACGTXACGT" + pairs[2][0], b"NACGTXACGGT" + pairs[2][1])
    return pairs


# (penalties, adaptive, k_win, s_cap, length, error, raw bytes, global,
#  pairs); the semi-global windows span every diagonal of the batch
CASES = {
    "tier0": (Penalties(4, 6, 2), ADAPTIVE, 128, 640, 300, 0.05, False, True,
              24),
    "tier1": (Penalties(4, 6, 2), ADAPTIVE, 512, 1920, 300, 0.1, False, True,
              24),
    "tier2": (Penalties(4, 6, 2), ADAPTIVE, 1152, 2500, 500, 0.2, False,
              True, 24),
    "no_reduce": (Penalties(4, 6, 2), None, 768, 1200, 300, 0.05, False,
                  True, 24),
    "degenerate": (Penalties(2, 3, 1), ADAPTIVE, 128, 512, 300, 0.05, False,
                   True, 24),
    "wide_penalties": (Penalties(9, 13, 5), ADAPTIVE, 256, 1024, 200, 0.05,
                       False, True, 24),
    "overflow": (Penalties(4, 6, 2), ADAPTIVE, 128, 80, 300, 0.05, False,
                 True, 24),
    "raw_bytes": (Penalties(4, 6, 2), ADAPTIVE, 128, 640, 300, 0.05, True,
                  True, 24),
    "semi_l200": (Penalties(4, 6, 2), ADAPTIVE, 512, 256, 200, 0.05, False,
                  False, 24),
    "semi_l1000": (Penalties(4, 6, 2), ADAPTIVE, 2048, 640, 1000, 0.05,
                   False, False, 128),
    "semi_overflow": (Penalties(4, 6, 2), ADAPTIVE, 512, 40, 200, 0.05,
                      False, False, 24),
    "semi_no_reduce": (Penalties(4, 6, 2), None, 512, 256, 200, 0.05, False,
                       False, 24),
    # mismatch 1, then gap extension 1: next() reads the row the reduce of
    # the same step zeroed
    "x1": (Penalties(1, 4, 2), ADAPTIVE, 128, 512, 300, 0.1, False, True,
           24),
    "e1": (Penalties(3, 2, 1), ADAPTIVE, 128, 512, 300, 0.1, False, True,
           24),
    "semi_e1": (Penalties(2, 0, 1), ADAPTIVE, 512, 256, 200, 0.1, False,
                False, 24),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_plain(card, case):
    from wfa_tpu_torch import engine as te
    from wfa_tpu_torch.device_backtrace import (device_backtrace,
                                                device_backtrace_plain)
    from wfa_tpu_torch.kernel_engine import run_batch

    pen, ad, k_win, s_cap, length, err, raw, ga, n = CASES[case]
    cfg = te.EngineConfig(penalties=pen, global_alignment=ga, adaptive=ad,
                          k_win=k_win, s_cap=s_cap)
    packed = te._pack_all(_pairs(n, length, err, 7, raw), k_win,
                          global_alignment=ga)
    assert (packed[8] is None) == raw
    qb, tbuf, qlen, tlen, toff, Lq, Ltb = te.inputs_from_packed(packed, card)
    args = (qb, tbuf, qlen, tlen, toff)
    ref = te.run_batch_plain(*args, cfg=cfg, Lq=Lq, Ltb=Ltb)
    got = run_batch(*args, cfg=cfg, Lq=Lq, Ltb=Ltb)
    for a, b in zip(ref[:4] + ref[5], got[:4] + got[5]):
        assert torch.equal(a, b)
    ok = ref[1] & ~ref[2]
    if case.endswith("overflow"):
        assert ref[2].any() and ok.any()
    elif not ga:
        # full-span windows hold every pair; only the two prefix pairs of
        # _pairs may need a score past the cap to reach their global end
        assert int(ok.sum()) >= n - 2
    for b in torch.nonzero(ok).flatten().tolist():
        f = int(ref[0][b])
        assert torch.equal(ref[4][:, :f + 1, b], got[4][:, :f + 1, b]), b

    shift, _ = te._token_plan(s_cap, pen, Lq, Ltb)
    end_s, end_k, end_cell = got[5]
    bt_args = (got[4], end_cell, -toff, end_s, end_k, qlen, tlen, ok)
    kw = dict(penalties=pen, S=s_cap, K=k_win, token_shift=shift,
              split_ext_codes=ga, global_alignment=ga)
    for a, b in zip(device_backtrace_plain(*bt_args, **kw),
                    device_backtrace(*bt_args, **kw)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("side", ["shared", "scratch"])
@pytest.mark.parametrize("mode", ["global", "long", "kw"])
def test_workspace_sides_match_plain(card, mode, side):
    """K1, K1-long and K1-kw with their workspace in shared memory and in
    the device scratch, at the two windows on either side of the limit
    (768 and 896 for K1 at 4/6/2, 512 and 640 for K1-long; for K1-kw's
    warp shape with 16-bit cells, one pair a block here, 5504 and 5632, KW
    the narrowest its row base allows)."""
    from wfa_tpu_torch import engine as te
    from wfa_tpu_torch.fuzz import limit_sides
    from wfa_tpu_torch.kernel_engine import (_kw_launch, _sms, kw_mode,
                                             run_batch, run_batch_long,
                                             warp_plan, workspace)

    cfg = te.EngineConfig(penalties=Penalties(4, 6, 2), adaptive=ADAPTIVE,
                          s_cap=512)
    cmode = {"global": 0, "long": 2, "kw": "kw16"}[mode]
    k_win = limit_sides(cfg, cmode)[side == "scratch"]
    kw = max(256, -(-(k_win - 31 * 32) // 128) * 128)
    cfg = dataclasses.replace(cfg, k_win=k_win,
                              aux_kw=kw if mode == "kw" else None)
    assert workspace(cfg, cmode)[1] == (side == "shared")
    pairs = _pairs(16, 300, 0.1, 23)
    ins = te.inputs_from_packed(te._pack_all(pairs, k_win), card)
    if mode == "kw":
        # one pair a block, the workspace where this side puts it (the
        # plan keeps 16 pairs' in the scratch)
        assert kw_mode(ins[6]) == "kw16"
        plan = warp_plan(cfg, cmode, len(pairs), _sms(card), 1,
                         side == "scratch")
    kw = dict(cfg=cfg, Lq=ins[5], Ltb=ins[6])
    if mode == "global":
        ref = te.run_batch_plain(*ins[:5], **kw)
        got = run_batch(*ins[:5], **kw)
        for a, b in zip(ref[:4] + ref[5], got[:4] + got[5]):
            assert torch.equal(a, b)
        ref, got = ref[:5], got[:5]
    elif mode == "long":
        ref = te.run_batch_long_plain(*ins[:5], **kw)
        got = run_batch_long(*ins[:5], **kw)
    else:
        ref = te.canonical_kw(te.run_batch_kw_plain(*ins[:5], **kw))
        got = te.canonical_kw(_kw_launch(*ins[:5], **kw, plan=plan))
    ok = ref[1] & ~ref[2]
    assert int(ok.sum()) >= len(pairs) - 2
    for a, b in zip(ref[:4], got[:4]):
        assert torch.equal(a, b)
    for b in torch.nonzero(ok).flatten().tolist():
        f = int(ref[0][b])
        assert torch.equal(ref[4][:, :f + 1, b], got[4][:, :f + 1, b]), b
        if mode == "long":
            assert torch.equal(ref[5][b, :f + 1], got[5][b, :f + 1]), b
        elif mode == "kw":
            assert torch.equal(ref[5][:f + 1, b], got[5][:f + 1, b]), b


def test_workspace_matches_the_kernel(card):
    """kernel_engine.workspace, which places and sizes the score loop's
    workspace at launch, gives what the kernel's own layout gives (the C
    entry wfa_workspace), over windows, penalties and every mode; and a
    launch whose workspace cannot fit shared memory is refused."""
    import ctypes

    from wfa_tpu_torch import _build
    from wfa_tpu_torch import engine as te
    from wfa_tpu_torch.kernel_engine import (C_MODES, PREFIX_SHAPES,
                                             SHARED_OPTIN, WARP_MODES,
                                             WARP_PAIRS, loop_args,
                                             prefix_plan, warp_plan,
                                             workspace)

    lib = _build.library()
    shared = ctypes.c_int(-1)
    for pen in (Penalties(4, 6, 2), Penalties(1, 4, 2), Penalties(3, 2, 1),
                Penalties(9, 13, 5), Penalties(2, 0, 1)):
        for k in (64, 100, 128, 256, 384, 512, 640, 768, 896, 2048, 20096):
            cfg = te.EngineConfig(penalties=pen, k_win=k)
            for mode, cmode in C_MODES.items():
                ints = lib.wfa_workspace(
                    k, pen.mismatch, pen.gap_open + pen.gap_ext, pen.gap_ext,
                    cmode, ctypes.byref(shared))
                assert workspace(cfg, mode) == (ints, bool(shared.value)), (
                    pen, k, mode)
    assert lib.wfa_workspace(128, 4, 8, 2, 9, ctypes.byref(shared)) == -1
    # the warp shape's launch plan (K1-kw, K4): its shared memory at every
    # pairs a block and place, and the launches the kernel refuses (-1):
    # more than a block may have, pairs outside [1, 16], another mode
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for pen in (Penalties(4, 6, 2), Penalties(4, 6, 1), Penalties(9, 13, 5)):
        for k in (128, 256, 512, 1024, 2688, 2816):
            cfg = te.EngineConfig(penalties=pen, k_win=k)
            args = (k, pen.mismatch, pen.gap_open + pen.gap_ext, pen.gap_ext)
            for mode in WARP_MODES:
                for pairs in range(1, WARP_PAIRS + 1):
                    for scratch in (True, False):
                        plan = warp_plan(cfg, mode, 64, sms, pairs, scratch)
                        want = (plan.shared_bytes if plan.shared_bytes
                                <= SHARED_OPTIN else -1)
                        assert lib.wfa_warp_shared(
                            *args, C_MODES[mode], pairs, scratch) == want
                for B in (1, 64, 133, 1320, 1321, 2048):
                    plan = warp_plan(cfg, mode, B, sms)
                    assert plan.shared_bytes == lib.wfa_warp_shared(
                        *args, C_MODES[mode], plan.pairs, plan.scratch)
                for pairs in (0, WARP_PAIRS + 1):
                    assert lib.wfa_warp_shared(*args, C_MODES[mode], pairs,
                                               1) == -1
            assert lib.wfa_warp_shared(*args, 0, 1, 1) == -1
    # K3's launch plan: its shared memory at every width and place, and
    # the launches the kernel refuses (-1): a place that does not fit, a
    # width not built
    for pen in (Penalties(4, 6, 2), Penalties(4, 6, 1), Penalties(9, 13, 5)):
        for k in (512, 2048, 3072, 3200, 6272, 6400, 20096):
            cfg = te.EngineConfig(penalties=pen, k_win=k)
            args = (k, pen.mismatch, pen.gap_open + pen.gap_ext, pen.gap_ext)
            for cell16 in (False, True):
                for t, cl in PREFIX_SHAPES:
                    for scratch in (True, False):
                        plan = prefix_plan(cfg, 64, cell16, sms, t, scratch,
                                           cl)
                        # the slots grow with the block's warps, so the
                        # workspace fits shared memory by shape
                        ok = scratch or (cl == 1 and plan.shared_bytes
                                         <= SHARED_OPTIN)
                        assert lib.wfa_prefix_shared(
                            *args, cell16, t, cl, scratch) == (
                                plan.shared_bytes if ok else -1)
                for B in (64, 256, 2048):
                    plan = prefix_plan(cfg, B, cell16, sms)
                    assert plan.shared_bytes == lib.wfa_prefix_shared(
                        *args, cell16, plan.threads, plan.cluster,
                        plan.scratch)
                for t, cl in ((64, 1), (128, 1), (512, 2), (1024, 4)):
                    assert lib.wfa_prefix_shared(*args, cell16, t, cl, 1) == -1
    # a null scratch where the workspace does not fit: refused, and the
    # context stays usable
    cfg = te.EngineConfig(penalties=Penalties(4, 6, 2), adaptive=ADAPTIVE,
                          k_win=2048, s_cap=64)
    assert not workspace(cfg, 0)[1]
    ins = te.inputs_from_packed(te._pack_all(_pairs(4, 100, 0.05, 5), 2048),
                                card)
    aux = torch.empty((3, 64, 4, 2048), dtype=torch.int32, device=card)
    args = list(loop_args(*ins[:5], cfg, ins[5], ins[6], 0, aux, None)[0])
    assert args[19] is not None
    args[19] = None  # the scratch
    with pytest.raises(_build.KernelError):
        _build.launch("wfa_score_loop", *args, _build.stream_ptr(card))
    torch.cuda.synchronize()


@pytest.mark.parametrize("mode", ["global", "long", "kw"])
def test_extension_to_the_last_row_end(card, mode):
    """A pair whose extension runs to the last byte of the batch's last
    query row and of its last target row: the word-wise compare loads no
    word past the rows' end."""
    from wfa_tpu_torch import engine as te
    from wfa_tpu_torch.kernel_engine import (run_batch, run_batch_kw,
                                             run_batch_long)

    rng = np.random.default_rng(29)
    s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 384)].tobytes()
    pairs = _pairs(7, 300, 0.05, 31) + [(s, s)]
    cfg = te.EngineConfig(penalties=Penalties(4, 6, 2), adaptive=ADAPTIVE,
                          k_win=256, s_cap=256,
                          aux_kw=256 if mode == "kw" else None)
    packed = te._pack_all(pairs, 256)
    qb, tbuf, qlen, tlen, toff, Lq, Ltb = te.inputs_from_packed(packed, card)
    # the last pair fills its query row and its target row to the end
    assert int(qlen[-1]) == Lq and int(toff[-1] + tlen[-1]) == Ltb
    args, kw = (qb, tbuf, qlen, tlen, toff), dict(cfg=cfg, Lq=Lq, Ltb=Ltb)
    run, plain = {"global": (run_batch, te.run_batch_plain),
                  "long": (run_batch_long, te.run_batch_long_plain),
                  "kw": (run_batch_kw, te.run_batch_kw_plain)}[mode]
    # rows cut to the batch's last pair: its rows end the allocations
    last = tuple(a[-1:].contiguous() for a in args)
    for batch in (args, last):
        ref, got = plain(*batch, **kw), run(*batch, **kw)
        for a, b in zip(ref[:4], got[:4]):
            assert torch.equal(a, b)
        assert bool(got[1][-1]) and int(got[0][-1]) == 0  # score 0


def _guard_pair(seed):
    """A pair whose score-8 row spreads past the int16 cells' 4095 with
    reduction off: diagonal 0 runs a 4,200-base shared stretch, while
    diagonals -1 and +1 open from the score-0 seed near offset 1."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    run = acgt[rng.integers(0, 4, 4200)].tobytes()
    tail = acgt[rng.integers(0, 4, 30)].tobytes()
    return b"AG" + run + b"T" + tail, b"AC" + run + b"G" + tail


# (penalties, adaptive, k_win, s_cap, length, error, pairs)
LONG_CASES = {
    "l5000": (Penalties(4, 6, 2), ADAPTIVE, 256, 2816, 5000, 0.05, 16),
    "l5000_degenerate": (Penalties(2, 3, 1), ADAPTIVE, 256, 1536, 5000,
                         0.05, 16),
    "overflow": (Penalties(4, 6, 2), ADAPTIVE, 256, 1440, 5000, 0.05, 16),
    "int16_guard": (Penalties(4, 6, 2), None, 64, 64, 300, 0.0, 4),
}


@pytest.mark.parametrize("case", list(LONG_CASES))
def test_long_kernels_match_plain(card, case):
    """K1-long and K2 over its rebased aux against their plain versions:
    every out row, the int16 aux rows and bases <= final_s of done pairs,
    the tokens and the chase iterations."""
    from wfa_tpu_torch import engine as te
    from wfa_tpu_torch.device_backtrace import (device_backtrace,
                                                device_backtrace_plain)
    from wfa_tpu_torch.kernel_engine import run_batch_long

    pen, ad, k_win, s_cap, length, err, n = LONG_CASES[case]
    cfg = te.EngineConfig(penalties=pen, adaptive=ad, k_win=k_win,
                          s_cap=s_cap)
    pairs = generate_pairs(n, length, err, seed=13)
    if case == "int16_guard":
        pairs[1] = _guard_pair(5)
    qb, tbuf, qlen, tlen, toff, Lq, Ltb = te.inputs_from_packed(
        te._pack_all(pairs, k_win), card)
    args = (qb, tbuf, qlen, tlen, toff)
    ref = te.run_batch_long_plain(*args, cfg=cfg, Lq=Lq, Ltb=Ltb)
    got = run_batch_long(*args, cfg=cfg, Lq=Lq, Ltb=Ltb)
    for a, b in zip(ref[:4], got[:4]):
        assert torch.equal(a, b)
    ok = ref[1] & ~ref[2]
    if case == "int16_guard":
        assert bool(ref[2][1]) and int(ok.sum()) == n - 1
    elif case == "overflow":
        assert ref[2].any() and ok.any()
    else:
        assert bool(ok.all())
    for b in torch.nonzero(ok).flatten().tolist():
        f = int(ref[0][b])
        assert torch.equal(ref[4][:, :f + 1, b], got[4][:, :f + 1, b]), b
        assert torch.equal(ref[5][b, :f + 1], got[5][b, :f + 1]), b

    shift, _ = te._token_plan(s_cap, pen, Lq, Ltb)
    bt_args = (got[4], got[3], -toff, got[0], tlen - qlen, qlen, tlen, ok)
    kw = dict(penalties=pen, S=s_cap, K=k_win, token_shift=shift,
              split_ext_codes=True, aux_base=got[5], return_iters=True)
    for a, b in zip(device_backtrace_plain(*bt_args, **kw),
                    device_backtrace(*bt_args, **kw)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# (adaptive, KW, k_win, s_cap, length, error, pairs, seed), pairs (m, a)
# meaning int(m x the card's SMs) + a; "escape" never trims the band,
# which outgrows its 128 columns in every pair; "l9000"'s target buffer
# passes the 8189 columns of 16-bit cells, so it runs int32 ones;
# "k_win_258" a window that is no multiple of 8 (the flush a cell a lane
# across the row).  The
# "pairs_*", "shared_*" and "scratch_*" cases sit on either side of a
# threshold of the warp shape's launch plan (kernel_engine.warp_plan: as
# many pairs a block as each SM gets; the workspace in the scratch up to 8
# pairs an SM, past it in shared memory while an SM holds them there:
# with 16-bit cells all 16 at k_win 256, 10 at 512), KW_PLANS their plans
KW_CASES = {
    "l4000": (ADAPTIVE, 256, 256, 2304, 4000, 0.05, 16, 19),
    "window_shift": (ADAPTIVE, 256, 512, 512, 400, 0.10, 24, 19),
    "escape": (AdaptiveReductionOption(10, 10 ** 6, 1), 128, 256, 512, 300,
               0.10, 8, 5),
    "l9000": (ADAPTIVE, 256, 256, 5120, 9000, 0.05, 8, 19),
    "k_win_258": (ADAPTIVE, 256, 258, 512, 400, 0.05, 16, 19),
    "pairs_1": (ADAPTIVE, 256, 256, 512, 400, 0.05, (1, 0), 19),
    "pairs_2": (ADAPTIVE, 256, 256, 512, 400, 0.05, (1, 1), 19),
    "scratch_8": (ADAPTIVE, 256, 256, 512, 400, 0.05, (8, 0), 19),
    "shared_9": (ADAPTIVE, 256, 256, 512, 400, 0.05, (8, 1), 19),
    "k512_shared_10": (ADAPTIVE, 512, 512, 512, 400, 0.05, (10, 0), 19),
    "k512_scratch_11": (ADAPTIVE, 512, 512, 512, 400, 0.05, (10, 1), 19),
}
# (pairs a block, the workspace in the scratch) of the plan's threshold
# cases
KW_PLANS = {"l9000": (1, True), "pairs_1": (1, True), "pairs_2": (2, True),
            "scratch_8": (8, True), "shared_9": (9, False),
            "k512_shared_10": (10, False), "k512_scratch_11": (11, True)}


def _count(n, sms):
    return n if isinstance(n, int) else int(n[0] * sms) + n[1]


@pytest.mark.parametrize("case", list(KW_CASES))
def test_kw_kernels_match_plain(card, case):
    """K1-kw against run_batch_kw_plain (every out row; the int16 aux rows
    and sbase words <= final_s of served pairs, the rest zeroed on both
    sides) and K2 over its sbase words against its plain version."""
    from wfa_tpu_torch import engine as te
    from wfa_tpu_torch.device_backtrace import (device_backtrace,
                                                device_backtrace_plain)
    from wfa_tpu_torch.kernel_engine import (_sms, kw_mode, run_batch_kw,
                                             warp_plan)

    ad, kw, k_win, s_cap, length, err, n, seed = KW_CASES[case]
    n = _count(n, _sms(card))
    cfg = te.EngineConfig(penalties=Penalties(4, 6, 2), adaptive=ad,
                          k_win=k_win, s_cap=s_cap, aux_kw=kw)
    pairs = generate_pairs(n, length, err, seed=seed)
    qb, tbuf, qlen, tlen, toff, Lq, Ltb = te.inputs_from_packed(
        te._pack_all(pairs, k_win), card)
    assert kw_mode(Ltb) == (3 if case == "l9000" else "kw16")
    if case in KW_PLANS:
        plan = warp_plan(cfg, kw_mode(Ltb), n, _sms(card))
        assert (plan.pairs, plan.scratch) == KW_PLANS[case]
    args = (qb, tbuf, qlen, tlen, toff)
    ref = te.canonical_kw(te.run_batch_kw_plain(*args, cfg=cfg, Lq=Lq,
                                                Ltb=Ltb))
    got = run_batch_kw(*args, cfg=cfg, Lq=Lq, Ltb=Ltb)
    for a, b in zip(ref, te.canonical_kw(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ok = ref[1] & ~ref[2]
    if case == "escape":
        assert not bool(ok.any())
    else:
        assert int(ok.sum()) >= n - 2
    if case == "window_shift":
        assert int((ref[5] & 31).max()) > 0

    shift, _ = te._token_plan(s_cap, cfg.penalties, Lq, Ltb)
    bt_args = (got[4], got[3], -toff, got[0], tlen - qlen, qlen, tlen, ok)
    bkw = dict(penalties=cfg.penalties, S=s_cap, K=kw, token_shift=shift,
               split_ext_codes=True, aux_sbase=got[5], return_iters=True)
    for a, b in zip(device_backtrace_plain(*bt_args, **bkw),
                    device_backtrace(*bt_args, **bkw)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("ga,engine,s_cap", [
    (True, "auto", 640), (False, "auto", 640), (True, "long", 640),
    (True, "kw", 640), (True, "auto", 65528)],
    ids=["global", "semi", "long", "kw", "raw_outputs"])
def test_align_full2_card_matches_cpu(card, ga, engine, s_cap):
    """The whole device part of the main path: the outputs from the
    kernels equal those from the plain versions (the byte streams, or the
    raw streams where the token stream passes 2**16 slots)."""
    from wfa_tpu_torch import engine as te

    k_win = 128 if ga else 1024
    if s_cap > 32000:
        k_win = 32  # keeps the [S, B, K] tensors small
    cfg = te.EngineConfig(penalties=Penalties(4, 6, 2), global_alignment=ga,
                          adaptive=ADAPTIVE, k_win=k_win, s_cap=s_cap,
                          aux_kw=k_win if engine == "kw" else None)
    pairs = (generate_pairs(16, 60, 0.05, seed=11) if s_cap > 32000
             else _pairs(64, 400, 0.05, 11))
    _, _, qlen, tlen, toff, Lq, Ltb, qp, tp = te._pack_all(
        pairs, k_win, global_alignment=ga)
    seq = torch.from_numpy(np.concatenate([qp, tp], axis=1))
    lens = torch.from_numpy(np.stack([qlen, tlen, toff], axis=1))
    cpu = te.align_full2(seq, lens, cfg=cfg, B=len(pairs), Lq=Lq, Ltb=Ltb,
                         packed=True, engine=engine)
    gpu = te.align_full2(seq.to(card), lens.to(card), cfg=cfg, B=len(pairs),
                         Lq=Lq, Ltb=Ltb, packed=True, engine=engine)
    assert sorted(cpu) == sorted(gpu)
    for key in cpu:
        assert torch.equal(cpu[key], gpu[key].cpu()), key


@pytest.mark.parametrize("engine,n,length,k_win,s_cap", [
    ("auto", 512, 1000, 128, 640), ("long", 16, 5000, 384, 2048)],
    ids=["K1", "K1-long"])
def test_align_full2_at_the_stride_matches_plain(card, monkeypatch, engine,
                                                 n, length, k_win, s_cap):
    """At 4/6/2 a global path runs its score loop and K2 at 2/3/1 over
    (s_cap - 2) // 2 + 2 rows (``engine.score_stride``): the card's
    streams equal the plain versions' and the card's at stride 1."""
    from wfa_tpu_torch import engine as te

    cfg = te.EngineConfig(penalties=Penalties(4, 6, 2), adaptive=ADAPTIVE,
                          k_win=k_win, s_cap=s_cap)
    assert te.score_stride(cfg) == 2
    pairs = _pairs(n, length, 0.05, 17)
    _, _, qlen, tlen, toff, Lq, Ltb, qp, tp = te._pack_all(pairs, k_win)
    seq = torch.from_numpy(np.concatenate([qp, tp], axis=1))
    lens = torch.from_numpy(np.stack([qlen, tlen, toff], axis=1))
    kw = dict(cfg=cfg, B=len(pairs), Lq=Lq, Ltb=Ltb, packed=True,
              engine=engine)
    cpu = te.align_full2(seq, lens, **kw)
    gpu = te.align_full2(seq.to(card), lens.to(card), **kw)
    monkeypatch.setattr(te, "score_stride", lambda c: 1)
    gpu1 = te.align_full2(seq.to(card), lens.to(card), **kw)
    meta, _ = te.decode_outputs(pairs, cpu["mtb"].numpy(), cpu["lg"].numpy())
    assert (meta[:, te.M_OVF] == 0).sum() >= n - 2
    assert sorted(cpu) == sorted(gpu) == sorted(gpu1) == ["lg", "mtb"]
    for key in cpu:
        assert torch.equal(cpu[key], gpu[key].cpu()), key
        assert torch.equal(gpu1[key], gpu[key]), key


def test_wrappers_check_their_inputs(card):
    import dataclasses

    from wfa_tpu_torch import engine as te
    from wfa_tpu_torch._build import KernelError
    from wfa_tpu_torch.kernel_engine import run_batch, run_batch_kw

    cfg = te.EngineConfig(penalties=Penalties(4, 6, 2), adaptive=ADAPTIVE)
    ins = te.inputs_from_packed(te._pack_all(_pairs(4, 100, 0.05, 3), 128),
                                card)
    qb, tbuf, qlen, tlen, toff, Lq, Ltb = ins
    with pytest.raises(TypeError):
        run_batch(qb, tbuf, qlen.long(), tlen, toff, cfg=cfg, Lq=Lq, Ltb=Ltb)
    with pytest.raises(ValueError):
        run_batch(qb, tbuf[:, ::2], qlen, tlen, toff, cfg=cfg, Lq=Lq,
                  Ltb=Ltb // 2)
    with pytest.raises(ValueError):
        run_batch(qb, tbuf.cpu(), qlen, tlen, toff, cfg=cfg, Lq=Lq, Ltb=Ltb)
    # K1-kw: a KW the TPU kernel refuses, and no KW at all
    for kw in (64, None):
        with pytest.raises(ValueError):
            run_batch_kw(*ins[:5], cfg=dataclasses.replace(cfg, aux_kw=kw),
                         Lq=Lq, Ltb=Ltb)
    # band slots over the default shared-memory limit: the kernel refuses
    # the launch and the wrapper raises KernelError (never a device fault)
    huge = te.EngineConfig(penalties=Penalties(5000, 6, 2), adaptive=ADAPTIVE)
    with pytest.raises(KernelError):
        run_batch(qb, tbuf, qlen, tlen, toff, cfg=huge, Lq=Lq, Ltb=Ltb)
    # the error does not stick to the context
    assert torch.equal(run_batch(*ins[:5], cfg=cfg, Lq=Lq, Ltb=Ltb)[0],
                       te.run_batch_plain(*ins[:5], cfg=cfg, Lq=Lq,
                                          Ltb=Ltb)[0])


def _suffix_pair(length, err, seed):
    """A read of the last ``length`` bases of a target twice as long, a
    share ``err`` of its bases substituted: its path runs near diagonal
    ``length``, so the narrow window lies past diagonal 0 (k02 > 0) and
    phase 2's target row holds only the target's suffix (toff2 < 0)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    t = acgt[rng.integers(0, 4, 2 * length)]
    q = t[length:].copy()
    hit = rng.random(length) < err
    q[hit] = acgt[(rng.integers(1, 4, length)[hit]
                   + np.searchsorted(acgt, q[hit])) % 4]
    return q.tobytes(), t.tobytes()


def _band_union(ex, b):
    """(lowest, highest) diagonal of pair b's live band slots in the
    phase-1 exports: M, then I and D."""
    lo, hi = [], []
    half = len(ex["b_ie"]) // 2
    for rows in (ex["b_m"], ex["b_ie"][:half], ex["b_ie"][half:]):
        w = len(rows) // 3
        live = rows[2 * w:, b] > 0
        lo += rows[:w, b][live].tolist()
        hi += rows[w:2 * w, b][live].tolist()
    return min(lo), max(hi)


def _at_span(pairs, Kf, seed):
    """``pairs`` with the first one's target cut or grown (random bases)
    so that its query and target lengths sum to Kf - 1: the batch's full
    span is then Kf (``semi2.prefix_span``) if no other pair is longer."""
    q, t = pairs[0]
    rng = np.random.default_rng(seed)
    need = Kf - 1 - len(q)
    extra = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, max(0, need - len(t)))].tobytes()
    return [(q, (t + extra)[:need])] + list(pairs[1:])


# (penalties, S0, k_win, s_cap, parts): the batch is the (pairs, length,
# error) parts in order, pairs (m, a) meaning int(m x the card's SMs) + a;
# tier 0 and tier 1 of the ladder at l=1000, l=5000 and l=10000 (Kf
# 20,096), and penalties whose x, e or o+e is below 2 (the TPU's whole-K
# EXPORT kernel, row 6 of PERF.md's table).  "edge" sizes phase 2's
# window to the suffix pair's band union, so its band starts at the
# window's left edge.  "overflow2" holds pairs still wider than K2 at S0,
# "done_in_prefix" pairs that finish inside the prefix, both beside live
# ones.  The "shared_*" and "scratch_*" cases sit on either side of each
# threshold of K3's block shape (kernel_engine.prefix_block_shape: in
# shared memory 512 threads up to a pair an SM, else 256; in the scratch a
# cluster of two 1024-thread blocks up to half a pair an SM, one block of
# 1024 up to a pair an SM for every 2048 columns of span, else 256).
# SPANS sets the full span of a case: for the "span_*" cases on either
# side of where K3's plan moves its int16 workspace from shared memory to
# the scratch (Kf 3072 and 3200 at 4/6/2), for "scratch_1024_1" and
# "scratch_256" at 4096.
SEMI2_CASES = {
    "tier0_l1000": (Penalties(4, 6, 2), 64, 256, 640, ((64, 1000, 0.05),)),
    "tier1_l1000": (Penalties(4, 6, 2), 112, 512, 1920, ((32, 1000, 0.1),)),
    "tier0_l5000": (Penalties(4, 6, 2), 64, 256, 2816, ((8, 5000, 0.05),)),
    "tier0_l10000": (Penalties(4, 6, 2), 64, 256, 5632,
                     ((4, 10000, 0.05),)),
    "penalties_4_6_1": (Penalties(4, 6, 1), 64, 256, 640,
                        ((32, 1000, 0.05),)),
    "edge": (Penalties(2, 1, 1), 40, None, 256, ((8, 200, 0.2),)),
    "overflow2": (Penalties(4, 6, 2), 64, 128, 640,
                  ((8, 1000, 0.02), (8, 1000, 0.25))),
    "done_in_prefix": (Penalties(4, 6, 2), 64, 256, 640,
                       ((8, 800, 0.002), (8, 800, 0.05))),
    "shared_512": (Penalties(4, 6, 2), 64, 256, 384, (((1, 0), 600, 0.05),)),
    "shared_256": (Penalties(4, 6, 2), 64, 256, 384, (((1, 1), 600, 0.05),)),
    "scratch_cluster": (Penalties(4, 6, 2), 64, 256, 1280,
                        (((0.5, 0), 2100, 0.05),)),
    "scratch_1024": (Penalties(4, 6, 2), 64, 256, 1280,
                     (((0.5, 1), 2100, 0.05),)),
    "scratch_1024_1": (Penalties(4, 6, 2), 64, 256, 1280,
                       (((2, 0), 1900, 0.05),)),
    "scratch_256": (Penalties(4, 6, 2), 64, 256, 1280,
                    (((2, 1), 1900, 0.05),)),
    "span_shared": (Penalties(4, 6, 2), 64, 256, 1024, ((8, 1500, 0.05),)),
    "span_scratch": (Penalties(4, 6, 2), 64, 256, 1024, ((8, 1500, 0.05),)),
    "narrow_258": (Penalties(4, 6, 2), 64, 258, 640, ((32, 1000, 0.05),)),
    "resume_warp_4": (Penalties(4, 6, 1), 64, 256, 640,
                      (((4, 0), 1000, 0.05),)),
    "resume_warp_5": (Penalties(4, 6, 1), 64, 256, 640,
                      (((4, 1), 1000, 0.05),)),
    "resume_shared_14": (Penalties(4, 6, 2), 112, 512, 640,
                         (((14, 0), 1000, 0.05),)),
    "resume_scratch_15": (Penalties(4, 6, 2), 112, 512, 640,
                          (((14, 1), 1000, 0.05),)),
}
# K4's plan (pairs a block; the workspace in the scratch) on either side
# of its thresholds ("narrow_258": a window that is no multiple of 4,
# whose exports and aux rows the warp shape takes a cell a lane; 4 and 5
# pairs a block at 4/6/1, whose band is the widest)
# (kernel_engine.warp_plan: at k_win 512 with int16 windows its workspace
# in shared memory up to 14 pairs an SM)
WARP = {"tier0_l1000": (1, False), "tier1_l1000": (1, False),
        "narrow_258": (1, False),
        "tier0_l10000": (1, False), "penalties_4_6_1": (1, False),
        "resume_warp_4": (4, False), "resume_warp_5": (5, False),
        "resume_shared_14": (14, False), "resume_scratch_15": (15, True)}
SPANS = {"span_shared": 3072, "span_scratch": 3200, "scratch_1024_1": 4096,
         "scratch_256": 4096}
# ((threads, blocks a pair), the workspace in the scratch) of the plan's
# threshold cases
THREADS = {"shared_512": ((512, 1), False), "shared_256": ((256, 1), False),
           "scratch_cluster": ((1024, 2), True),
           "scratch_1024": ((1024, 1), True),
           "scratch_1024_1": ((1024, 1), True),
           "scratch_256": ((256, 1), True)}


@pytest.mark.parametrize("case", list(SEMI2_CASES))
def test_semi2_kernels_match_plain(card, case):
    """K3 against prefix_export_plain (the exports with their don't-cares
    zeroed), K4 against run_batch_resume_plain on K3's exports (every out
    row, aux rows S0..final_s of pairs finished in phase 2), and K2 over
    both aux tensors against its plain version (tokens and chase
    iterations)."""
    from wfa_tpu_torch import engine as te
    from wfa_tpu_torch import semi2 as ts
    from wfa_tpu_torch.device_backtrace import (device_backtrace,
                                                device_backtrace_plain)
    from wfa_tpu_torch.kernel_engine import (prefix_plan, resume_mode,
                                             run_prefix, run_resume,
                                             warp_plan)

    pen, S0, k_win, s_cap, parts = SEMI2_CASES[case]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    pairs = [p for i, (n, length, err) in enumerate(parts)
             for p in generate_pairs(
                 n if isinstance(n, int) else int(n[0] * sms) + n[1],
                 length, err, seed=17 + i)]
    if case == "edge":
        pairs[0] = _suffix_pair(200, 0.2, 3)
    if case in SPANS:
        pairs = _at_span(pairs, SPANS[case], 5)
    packed = te._pack_all(pairs, 128, global_alignment=False)
    qb, tbuf, qlen, tlen, toff, Lq, Ltb = te.inputs_from_packed(packed, card)
    Kf = ts.prefix_span(packed[2], packed[3])
    plan = prefix_plan(te.EngineConfig(penalties=pen, k_win=Kf),
                       len(pairs), te.semi_cell16(Ltb), sms)
    if case in SPANS:
        assert Kf == SPANS[case]
    if case.startswith("span_"):
        assert te.semi_cell16(Ltb) and plan.scratch == (case == "span_scratch")
    if case in THREADS:
        assert ((plan.threads, plan.cluster), plan.scratch) == THREADS[case]
    args = (qb, tbuf, qlen, tlen, toff)
    if k_win is None:
        # the suffix pair's band union at S0 (K2 = Kf holds every band)
        wide = ts.prefix_export_plain(
            *args, cfg=te.EngineConfig(penalties=pen, global_alignment=False,
                                       adaptive=ADAPTIVE, k_win=Kf,
                                       s_cap=s_cap),
            Lq=Lq, Ltb=Ltb, S0=S0, K2=Kf)
        lo, hi = _band_union(wide, 0)
        ak = int(packed[3][0]) - int(packed[2][0])
        k_win = max(hi, ak) - min(lo, ak) + 1
    cfg = te.EngineConfig(penalties=pen, global_alignment=False,
                          adaptive=ADAPTIVE, k_win=k_win, s_cap=s_cap)
    if case in WARP:
        wplan = warp_plan(cfg, resume_mode(Ltb), len(pairs), sms)
        assert (wplan.pairs, wplan.scratch) == WARP[case]
    pkw = dict(cfg=dataclasses.replace(cfg, k_win=Kf), Lq=Lq, Ltb=Ltb,
               S0=S0, K2=k_win)
    ref = ts.canonical_exports(ts.prefix_export_plain(*args, **pkw))
    ex = run_prefix(*args, **pkw)
    got = ts.canonical_exports(ex)
    for key in ref:
        assert ref[key].dtype == got[key].dtype, key
        assert torch.equal(ref[key], got[key]), key
    m1 = ex["meta1"].cpu()
    live = (m1[:, ts.M1_DONE] == 0) & (m1[:, ts.M1_OVF] == 0)
    assert bool(live.any())
    if case == "overflow2":
        assert bool((m1[:, ts.M1_OVF] > 0).any())
    if case == "done_in_prefix":
        assert bool((m1[:, ts.M1_DONE] > 0).any())
    k02 = m1[:, ts.M1_K02].numpy()
    if case == "edge":
        # the window starts past diagonal 0, at the band's low end
        assert bool(live[0]) and k02[0] > 0
        assert _band_union(ex, 0)[0] == k02[0]

    t2raw, _, toff2, Ltb2 = ts.replace_targets([t for _, t in pairs], k02)
    tb2 = torch.from_numpy(t2raw).to(card)
    toff2 = torch.from_numpy(toff2).to(card)
    keys = ("win_m", "win_i", "win_d", "ainit", "b_m", "b_ie", "meta1")
    r_args = (qb, tb2, qlen, tlen, toff2, *(ex[k] for k in keys))
    rkw = dict(cfg=cfg, Lq=Lq, Ltb2=Ltb2, Ltb_full=Ltb, S0=S0)
    ref2 = ts.canonical_resume(te.run_batch_resume_plain(*r_args, **rkw), S0)
    res = run_resume(*r_args, **rkw)
    got2 = ts.canonical_resume(res, S0)
    for a, b in zip(ref2[:5] + ref2[5], got2[:5] + got2[5]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ok = res[1] & ~res[2]
    if case == "edge":
        assert bool(toff2[0] < 0)
    else:
        assert bool((ok & (res[0] >= S0)).any())

    shift, _ = te._token_plan(s_cap, pen, Lq, Ltb)
    end_s, end_k, end_cell = res[5]
    bt_args = (res[4], end_cell, -toff2, end_s, end_k, qlen, tlen, ok)
    kw = dict(penalties=pen, S=s_cap, K=k_win, token_shift=shift,
              global_alignment=False, aux_old=ex["aux_old"],
              k0_old=-(qlen - 1), s_split=S0, return_iters=True)
    for a, b in zip(device_backtrace_plain(*bt_args, **kw),
                    device_backtrace(*bt_args, **kw)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# K3's plain exports by batch, shared by the plan cases
_PLAIN_K3 = {}


@pytest.mark.parametrize("place", ["scratch", "shared"])
@pytest.mark.parametrize("shape", ["256", "512", "1024", "1024x2"])
@pytest.mark.parametrize("length", [1000, 5000], ids=["int16", "int32"])
def test_prefix_plans_match_plain(card, length, shape, place):
    """K3 at every launch plan it can take (each block shape it is built
    for, threads x blocks a pair, its workspace in the device scratch or,
    at Kf 2048 in one block a pair, in shared memory) gives the exports of
    its plain version, at both cell types (int16 at l=1000, int32 at
    l=5000, where it runs in the scratch only); a plan that does not fit
    is refused."""
    from wfa_tpu_torch import _build
    from wfa_tpu_torch import engine as te
    from wfa_tpu_torch import semi2 as ts
    from wfa_tpu_torch.kernel_engine import (_prefix_launch, prefix_plan,
                                             workspace)

    pen = Penalties(4, 6, 2)
    pairs = generate_pairs(16 if length == 1000 else 4, length, 0.05,
                           seed=41)
    packed = te._pack_all(pairs, 128, global_alignment=False)
    args = te.inputs_from_packed(packed, card)
    Kf = ts.prefix_span(packed[2], packed[3])
    cfg = te.EngineConfig(penalties=pen, global_alignment=False,
                          adaptive=ADAPTIVE, k_win=Kf, s_cap=640)
    kw = dict(cfg=cfg, Lq=args[5], Ltb=args[6], S0=64, K2=256)
    cell16 = te.semi_cell16(args[6])
    assert cell16 == (length == 1000)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    threads, _, cl = shape.partition("x")
    plan = prefix_plan(cfg, len(pairs), cell16, sms, int(threads),
                       place == "scratch", int(cl or 1))
    if place == "shared" and (plan.cluster > 1 or not workspace(
            cfg, "prefix16" if cell16 else "prefix")[1]):
        with pytest.raises(_build.KernelError):
            _prefix_launch(*args[:5], **kw, plan=plan)
        return
    if length not in _PLAIN_K3:
        _PLAIN_K3[length] = ts.canonical_exports(
            ts.prefix_export_plain(*args[:5], **kw))
    ref = _PLAIN_K3[length]
    got = ts.canonical_exports(_prefix_launch(*args[:5], **kw, plan=plan))
    for key in ref:
        assert ref[key].dtype == got[key].dtype, key
        assert torch.equal(ref[key], got[key]), key


def _interleave(*groups):
    return [p for row in zip(*groups) for p in row]


@pytest.mark.parametrize("kernel", ["kw", "kw32", "resume"])
def test_warp_pairs_leave_one_block_at_different_steps(card, kernel):
    """K1-kw and K4 at every launch plan (every_warp_plan: 1-16 pairs a
    block, shared memory and the scratch) against their
    plain versions, on a batch whose pairs leave each block at different
    steps: for K1-kw escaping pairs beside served ones (16-bit cells, and
    "kw32" int32 ones, its batch holding one pair of 8,400 bases); for
    K4 pairs done in phase 1, pairs overflowed at entry (wider than the
    narrow window at S0), and pairs finishing early and late, interleaved
    so that every block holds each kind."""
    from wfa_tpu_torch import engine as te
    from wfa_tpu_torch import semi2 as ts
    from wfa_tpu_torch.kernel_engine import (_kw_launch, _resume_launch,
                                             _sms, every_warp_plan, kw_mode,
                                             resume_mode)

    sms = _sms(card)
    if kernel.startswith("kw"):
        cfg = te.EngineConfig(penalties=Penalties(4, 6, 2),
                              adaptive=AdaptiveReductionOption(10, 10 ** 6,
                                                               1),
                              k_win=256, s_cap=512, aux_kw=128)
        pairs = _interleave(generate_pairs(16, 300, 0.10, seed=5),
                            generate_pairs(16, 60, 0.02, seed=6))
        if kernel == "kw32":
            long = (pairs[1][1] * 200)[:8400]
            pairs[1] = (long, long)
        ins = te.inputs_from_packed(te._pack_all(pairs, 256), card)
        assert kw_mode(ins[6]) == (3 if kernel == "kw32" else "kw16")
        kw = dict(cfg=cfg, Lq=ins[5], Ltb=ins[6])
        ref = te.canonical_kw(te.run_batch_kw_plain(*ins[:5], **kw))
        ok = ref[1] & ~ref[2]
        assert bool(ok.any()) and bool(ref[2].any())
        for plan in every_warp_plan(cfg, kw_mode(ins[6]), len(pairs), sms):
            got = te.canonical_kw(_kw_launch(*ins[:5], **kw, plan=plan))
            for a, b in zip(ref, got):
                assert a.dtype == b.dtype and torch.equal(a, b), plan
        return
    pen = Penalties(4, 6, 2)
    pairs = _interleave(generate_pairs(8, 800, 0.002, seed=21),
                        generate_pairs(8, 1000, 0.25, seed=22),
                        generate_pairs(8, 300, 0.05, seed=23),
                        generate_pairs(8, 1000, 0.05, seed=24))
    packed = te._pack_all(pairs, 128, global_alignment=False)
    qb, tbuf, qlen, tlen, toff, Lq, Ltb = te.inputs_from_packed(packed, card)
    Kf = ts.prefix_span(packed[2], packed[3])
    cfg = te.EngineConfig(penalties=pen, global_alignment=False,
                          adaptive=ADAPTIVE, k_win=128, s_cap=640)
    ex = ts.prefix_export_plain(
        qb, tbuf, qlen, tlen, toff, cfg=dataclasses.replace(cfg, k_win=Kf),
        Lq=Lq, Ltb=Ltb, S0=64, K2=128)
    m1 = ex["meta1"]
    assert bool((m1[:, ts.M1_DONE] > 0).any())
    assert bool((m1[:, ts.M1_OVF] > 0).any())
    t2raw, _, toff2, Ltb2 = ts.replace_targets([t for _, t in pairs],
                                               m1[:, ts.M1_K02].cpu().numpy())
    keys = ("win_m", "win_i", "win_d", "ainit", "b_m", "b_ie", "meta1")
    r_args = (qb, torch.from_numpy(t2raw).to(card), qlen, tlen,
              torch.from_numpy(toff2).to(card), *(ex[k] for k in keys))
    rkw = dict(cfg=cfg, Lq=Lq, Ltb2=Ltb2, Ltb_full=Ltb, S0=64)
    ref = ts.canonical_resume(te.run_batch_resume_plain(*r_args, **rkw), 64)
    ran = ref[1] & ~ref[2] & (ref[0] >= 64)
    assert int(ref[0][ran].min()) < int(ref[0][ran].max())
    for plan in every_warp_plan(cfg, resume_mode(Ltb), len(pairs), sms):
        got = ts.canonical_resume(_resume_launch(*r_args, **rkw, plan=plan),
                                  64)
        for a, b in zip(ref[:5] + ref[5], got[:5] + got[5]):
            assert a.dtype == b.dtype and torch.equal(a, b), plan


def _is_launch(e) -> bool:
    return e.get("cat") == "cuda_runtime" and e.get("name", "").startswith(
        ("cudaLaunchKernel", "cuLaunchKernel"))


def _launch_coverage(events) -> dict:
    """Of the kernel-launch runtime events issued off the caller's thread
    (the port's workers), how many lie inside a ``launch`` or ``shard``
    span of the same thread, and the largest distance in us from one
    outside to the nearest such span; by tid, the kinds of span and the
    runtime calls."""
    mine = [e for e in events if e.get("cat") == "wfa"]
    caller = {e["tid"] for e in mine if e["name"] == "call"}
    spans: dict = {}
    for e in mine:
        if e["name"] in ("launch", "shard"):
            spans.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"
               and e.get("ph") == "X"]
    launches = [e for e in runtime if e["tid"] not in caller
                and _is_launch(e)]
    inside, worst = 0, 0.0
    for e in launches:
        s, t = e["ts"], e["ts"] + e["dur"]
        own = spans.get(e["tid"], [])
        if any(a <= s and t <= b for a, b in own):
            inside += 1
        else:
            worst = max(worst, min((max(a - s, t - b) for a, b in own),
                                   default=float("inf")))
    by_tid: dict = {}
    for e in mine + runtime:
        kinds = by_tid.setdefault(str(e["tid"]), {})
        kinds[e["name"]] = kinds.get(e["name"], 0) + 1
    return {"caller": sorted(caller), "launches": len(launches),
            "inside": inside, "worst_us": worst, "by_tid": by_tid}


def test_spans_share_the_profilers_clock(card, tmp_path):
    """The recorder's timeline merged into a torch.profiler trace of three
    calls of 256 pairs of 50,000 bases at 5% (the global.l50000-e05
    cell's calls): at least 99% of the kernel launches the workers issue
    lie inside a ``launch`` or ``shard`` span of their own thread, with
    each worker's tid found from the trace's other runtime calls alone;
    the offset from the calls' marks agrees with the one from the wall
    clock (the trace's ``baseTimeNanoseconds``) within 1 ms.  Prints the
    coverage, the largest displacement, the two clock anchors
    (the calls' marks, the wall clock), the calls' records, and the
    calls' walls without and with a timeline on (no profiler)."""
    import json
    import time

    from torch.profiler import ProfilerActivity, profile

    from wfa_tpu_torch import Options, trace
    from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

    pairs = generate_pairs(256, 50000, 0.05, seed=41)
    pipe = AlignmentPipeline(PipelineConfig(
        Penalties(4, 6, 2), Options(True), ADAPTIVE, batch_size=2048,
        device="cuda", n_devices=1))
    walls = {"off": [], "on": []}

    def timed(what):
        t0 = time.perf_counter()
        pipe.align_all(pairs)
        walls[what].append(round(1e3 * (time.perf_counter() - t0), 3))

    try:
        pipe.align_all(pairs)  # warm: builds the kernels, fits the cap
        for what in ("off", "on", "on", "off") * 2:
            if what == "on":
                with trace.timeline():
                    timed(what)
            else:
                timed(what)
        with trace.timeline() as tl:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    pipe.align_all(pairs)
                torch.cuda.synchronize()
    finally:
        pipe.close()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        raw = json.load(fh)
    by_mark = tl.offset_ns(raw)
    by_wall = tl.wall_less_perf - int(raw.get("baseTimeNanoseconds", 0))
    # the launches counted below play no part in naming the workers
    tids = tl.tids(raw, by_mark)
    assert tids and tids == tl.tids(dict(raw, traceEvents=[
        e for e in raw["traceEvents"] if not _is_launch(e)]), by_mark)
    assert tl.merge(str(path)) > 0
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    got = _launch_coverage(events)
    print(f"clock: marks - wall clock {(by_mark - by_wall) / 1e3:.1f} us; "
          f"coverage {json.dumps(got)}")
    for rec in trace.records(3):
        print("record " + json.dumps(rec))
    print(f"call ms, timeline off and on: {json.dumps(walls)}")
    assert abs(by_mark - by_wall) < 1_000_000
    assert got["launches"] > 0
    assert got["inside"] >= 0.99 * got["launches"]


def test_the_cells_pack_runs_the_vector_body(card):
    """A call of the global.l50000-e05 cell's 256 pairs on the card's host:
    every base of the batch goes through the native direct pack, and
    through its vector body (the host's CPU has one)."""
    from wfa_tpu_torch import Options, native, trace
    from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

    pairs = generate_pairs(256, 50000, 0.05, seed=43)
    pipe = AlignmentPipeline(PipelineConfig(
        Penalties(4, 6, 2), Options(True), ADAPTIVE, batch_size=2048,
        device="cuda", n_devices=1))
    try:
        pipe.align_all(pairs)
    finally:
        pipe.close()
    rec = trace.records(1)[0]
    print(f"vector body {native.load().wfa_pack_vector()}; packed_bases "
          f"{rec['packed_bases']}, packed_vec_bases {rec['packed_vec_bases']}")
    assert rec["packed_bases"] > 0
    assert rec["packed_vec_bases"] == rec["packed_bases"]


def test_exact_kernels_match_plain_at_the_cells_caps(card, monkeypatch):
    """Exact global alignment at its benchmark shape (cell exact.l1000-e20:
    2048 pairs of 1,000 bases at 20% error a call, no wf-adaptive
    reduction): a pipeline of the cell's configuration runs two calls of
    the cell's traffic, the cold one at tier 0's score cap (640, which
    every pair overflows) and tier 1's (1920), the next at the cap its
    score memory settles on.  The first batch of each (k_win, s_cap) the
    path builds is recorded, and on it K1 without its reduce and K2 over
    its dense int32 aux are held to their plain versions (on the card, in
    slices of rows): every out row, the aux rows up to each served pair's
    final_s, the tokens and the chase iterations."""
    from pathlib import Path

    from portbench import manifest, run, traffic
    from wfa_tpu_torch import engine as te
    from wfa_tpu_torch.device_backtrace import (device_backtrace,
                                                device_backtrace_plain)
    from wfa_tpu_torch.kernel_engine import run_batch
    from wfa_tpu_torch.pipeline import AlignmentPipeline

    root = Path(__file__).resolve().parents[1]
    cell = manifest.cell(manifest.load(root), "exact.l1000-e20", root)
    pool = traffic.make_pool(cell.mix, 2**31 + 53)
    batches = {}
    orig = te.BatchAligner.submit_batch

    def spy(self, pairs, prepacked=None):
        key = (self.cfg.k_win, self.cfg.s_cap, self.engine)
        batches.setdefault(key, (self.cfg, list(pairs)))
        return orig(self, pairs, prepacked)

    monkeypatch.setattr(te.BatchAligner, "submit_batch", spy)
    pipe = AlignmentPipeline(run.pipeline_config(cell.config, "cuda"))
    try:
        for call in pool[:2]:
            pipe.align_all(call)
    finally:
        pipe.close()
    monkeypatch.undo()
    del pipe
    torch.cuda.empty_cache()
    caps = sorted(batches)
    print("exact caps (k_win, s_cap, engine, pairs): "
          f"{[key + (len(b[1]),) for key, b in batches.items()]}")
    assert {(k, e) for k, _, e in caps} == {(2048, "auto")}
    s_caps = {s for _, s, _ in caps}
    assert {640, 1920} <= s_caps and len(s_caps) >= 3
    for key in caps:
        cfg, pairs = batches[key]
        assert cfg.adaptive is None and cfg.global_alignment
        n = len(pairs)
        qb, tbuf, qlen, tlen, toff, Lq, Ltb = te.inputs_from_packed(
            te._pack_all(pairs, cfg.k_win), card)
        args = (qb, tbuf, qlen, tlen, toff)
        got = run_batch(*args, cfg=cfg, Lq=Lq, Ltb=Ltb)
        outs = got[:4] + got[5]
        served = 0
        for lo in range(0, n, 128):
            rows = slice(lo, min(n, lo + 128))
            ref = te.run_batch_plain(*(a[rows] for a in args), cfg=cfg,
                                     Lq=Lq, Ltb=Ltb)
            for a, b in zip(ref[:4] + ref[5], outs):
                assert torch.equal(a, b[rows]), (key, lo)
            ok = ref[1] & ~ref[2]
            served += int(ok.sum())
            for b in torch.nonzero(ok).flatten().tolist():
                f = int(ref[0][b])
                assert torch.equal(ref[4][:, :f + 1, b],
                                   got[4][:, :f + 1, lo + b]), (key, lo + b)
            del ref
        if key[1] == 640:
            assert served <= n // 10  # the overflow that sends it to tier 1
        else:
            assert served == n
        ok = got[1] & ~got[2]
        shift, _ = te._token_plan(cfg.s_cap, cfg.penalties, Lq, Ltb)
        end_s, end_k, end_cell = got[5]
        bt_args = (got[4], end_cell, -toff, end_s, end_k, qlen, tlen, ok)
        kw = dict(penalties=cfg.penalties, S=cfg.s_cap, K=cfg.k_win,
                  token_shift=shift, split_ext_codes=True,
                  global_alignment=True, return_iters=True)
        for a, b in zip(device_backtrace_plain(*bt_args, **kw),
                        device_backtrace(*bt_args, **kw)):
            assert a.dtype == b.dtype and torch.equal(a, b), key
        del got, outs, bt_args
        torch.cuda.empty_cache()
