"""PyTorch port vs the JAX package: the engine's stages on one packed batch.

The same numpy-packed batch (``wfa_tpu.engine.BatchAligner._pack_all``)
goes through each JAX function and its ``wfa_tpu_torch`` counterpart on
the CPU, where the port's kernel wrappers run their plain PyTorch
versions, in global and semi-global mode.  Every comparison is integer:
the tolerance is exact equality.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wfa_tpu import AdaptiveReductionOption, Options, Penalties
from wfa_tpu.device_backtrace import end_finder
from wfa_tpu.engine import BatchAligner as JaxBatchAligner
from wfa_tpu.engine import (_align_full2, _run_batch, _seed_rows,
                            _stop_tables, _unpack2)
from wfa_tpu.pallas_engine import pallas_run_batch
from wfa_tpu_torch import engine as te
from wfa_tpu_torch.kernel_engine import run_batch

from test_pallas_engine import random_pairs

torch.set_num_threads(2)

ADAPTIVE = AdaptiveReductionOption(10, 50, 1)


def _batch(seed, n=12, max_len=80, penalties=Penalties(4, 6, 2),
           adaptive=ADAPTIVE, k_win=128, s_cap=128, raw=False, ga=True):
    """A random batch and the JAX aligner that packed it; semi-global
    (``ga=False``) windows span every diagonal, k_win 256."""
    pairs = random_pairs(random.Random(seed), n, max_len)
    if raw:  # a non-ACGT byte forces the raw (unpacked) upload
        pairs[1] = (b"ACGTNNACGTACGGT", b"ACGTNACGTTACGGT")
    if not ga:
        k_win = 256
    jb = JaxBatchAligner(penalties, Options(ga), adaptive, k_win=k_win,
                         s_cap=s_cap, engine="jax")
    return pairs, jb, jb._pack_all(pairs)


def _jax_args(packed):
    qb, tbuf, qlen, tlen, toff = (jnp.asarray(a) for a in packed[:5])
    return qb, tbuf, qlen, tlen, toff


@pytest.mark.parametrize("raw", [False, True], ids=["packed", "raw"])
def test_engine_inputs_match_jax(raw):
    """_unpack2, _seed_rows and _stop_tables (words and fsa)."""
    pairs, jb, packed = _batch(11, raw=raw)
    qb, tbuf, qlen, tlen, toff, Lq, Ltb, qp, tp = packed
    K = jb.cfg.k_win
    ins = te.inputs_from_packed(packed, "cpu")
    jargs = _jax_args(packed)
    for mismatch in (4, 0):
        jseeds = _seed_rows(*jargs, mismatch=mismatch, global_alignment=True,
                            K=K, Lq=Lq, Ltb=Ltb)
        tseeds = te._seed_rows(*ins[:5], mismatch=mismatch, K=K, Ltb=Ltb)
        for js, ts in zip(jseeds, tseeds):
            for a, b in zip(js, ts):
                assert np.array_equal(np.asarray(a), b.numpy())
    jw, jf = _stop_tables(*jargs, K, Lq, Ltb)
    tw, tf = te._stop_tables(*ins[:5], K, Lq, Ltb)
    assert np.array_equal(np.asarray(jw), tw.numpy())
    assert np.array_equal(np.asarray(jf), tf.numpy())
    if raw:
        assert tp is None
        return
    for pk, L, lo, hi in ((qp, Lq, np.zeros_like(qlen), qlen),
                          (tp, Ltb, toff, toff + tlen)):
        j = _unpack2(jnp.asarray(pk), L, jnp.asarray(lo), jnp.asarray(hi))
        t = te._unpack2(torch.from_numpy(pk), L, torch.from_numpy(lo),
                        torch.from_numpy(hi))
        assert np.array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("raw", [False, True], ids=["packed", "raw"])
def test_semi_pack_and_seed_rows_match_jax(raw):
    """The semi-global pack (toff = qlen - 1), window origin and seed rows
    (first row and column, match and mismatch seeds, merged at x == 0)."""
    pairs, jb, packed = _batch(13, raw=raw, ga=False)
    K = jb.cfg.k_win
    for a, b in zip(te._pack_all(pairs, K, global_alignment=False), packed):
        assert (a is None and b is None) or np.array_equal(a, b)
    qb, tbuf, qlen, tlen, toff, Lq, Ltb = packed[:7]
    for q, t, o in zip(qlen, tlen, toff):
        assert (te.window_origin(int(q), int(t), K, False) == -int(o)
                == -(int(q) - 1))
    ins = te.inputs_from_packed(packed, "cpu")
    for mismatch in (4, 0):
        jseeds = _seed_rows(*_jax_args(packed), mismatch=mismatch,
                            global_alignment=False, K=K, Lq=Lq, Ltb=Ltb)
        tseeds = te._seed_rows(*ins[:5], mismatch=mismatch, K=K, Ltb=Ltb,
                               global_alignment=False)
        for js, ts in zip(jseeds, tseeds):
            for a, b in zip(js, ts):
                assert np.array_equal(np.asarray(a), b.numpy())
        assert bool(tseeds[0][3].all())
        assert bool(tseeds[1][3].any()) == (mismatch > 0)


def test_clz32_matches_lax():
    from jax import lax

    rng = np.random.default_rng(0)
    words = rng.integers(-(1 << 31), 1 << 31, size=4096, dtype=np.int64)
    words = np.concatenate([words, [0, -1, 1, -(1 << 31), (1 << 31) - 1]])
    words = words.astype(np.int32)
    assert np.array_equal(np.asarray(lax.clz(jnp.asarray(words))),
                          te._clz32(torch.from_numpy(words)).numpy())


@pytest.mark.parametrize("penalties,adaptive,s_cap,ga", [
    (Penalties(4, 6, 2), ADAPTIVE, 128, True),
    (Penalties(4, 6, 2), None, 128, True),
    (Penalties(2, 3, 1), ADAPTIVE, 128, True),
    (Penalties(4, 6, 2), ADAPTIVE, 48, True),  # score-cap overflows
    (Penalties(4, 6, 2), ADAPTIVE, 128, False),
    (Penalties(4, 6, 2), None, 128, False),
    (Penalties(2, 3, 1), ADAPTIVE, 128, False),
    (Penalties(4, 6, 2), ADAPTIVE, 32, False),
], ids=["adaptive", "plain", "degenerate", "overflow", "semi_adaptive",
        "semi_plain", "semi_degenerate", "semi_overflow"])
def test_run_batch_plain_matches_lockstep(penalties, adaptive, s_cap, ga):
    """run_batch_plain equals wfa_tpu.engine._run_batch on the whole
    final_s, done, overflow and aux; its end triple is (final_s, Ak,
    term_cell) in global mode and the JAX end finder's pick over the JAX
    history in semi-global mode."""
    pairs, jb, packed = _batch(21, penalties=penalties, adaptive=adaptive,
                               s_cap=s_cap, ga=ga)
    Lq, Ltb = packed[5], packed[6]
    B, S, K = len(pairs), jb.cfg.s_cap, jb.cfg.k_win
    st = _run_batch(*_jax_args(packed), cfg=jb.cfg, B=B, Lq=Lq, Ltb=Ltb)
    ins = te.inputs_from_packed(packed, "cpu")
    final_s, done, overflow, term_cell, aux, end = te.run_batch_plain(
        *ins[:5], cfg=te.config_from_jax(jb.cfg), Lq=Lq, Ltb=Ltb)
    assert np.array_equal(np.asarray(st.final_s), final_s.numpy())
    assert np.array_equal(np.asarray(st.done), done.numpy())
    assert np.array_equal(np.asarray(st.overflow), overflow.numpy())
    jaux = np.stack([np.asarray(st.aux_m), np.asarray(st.aux_i),
                     np.asarray(st.aux_d)])
    assert np.array_equal(jaux, aux.numpy())
    # term_cell is the stored M cell at (final_s, Ak)
    qlen, tlen, toff = packed[2:5]
    j_ak = (tlen - qlen) + toff
    hist = np.asarray(st.hist_m)
    ok = done.numpy() & ~overflow.numpy()
    b = np.arange(B)[ok]
    assert np.array_equal(hist[final_s.numpy()[ok], b, j_ak[ok]],
                          term_cell.numpy()[ok])
    end_s, end_k, end_cell = (a.numpy() for a in end)
    if ga:
        want = (final_s.numpy(), tlen - qlen, term_cell.numpy())
    else:
        k0 = -toff.astype(np.int32)
        js, jk, _ = (np.asarray(a) for a in end_finder(
            st.hist_m, jnp.asarray(k0), st.final_s, jnp.asarray(qlen),
            jnp.asarray(tlen), S, K))
        want = (js, jk, hist[js, np.arange(B), jk - k0])
    for a, w in zip((end_s, end_k, end_cell), want):
        assert np.array_equal(a[ok], np.asarray(w)[ok])
    if s_cap < 128:
        assert overflow.any() and (~overflow).any()


@pytest.mark.parametrize("ga", [True, False], ids=["global", "semi"])
def test_run_batch_plain_matches_pallas_interpret(ga):
    """run_batch_plain equals the Pallas kernel (interpret mode) on every
    pair it reports done and not overflowed: final_s, term_cell, the end
    triple (out rows 5-7) and the aux rows 0..final_s ([3, S, K, Bp]
    int16 -> [3, S, B, K] int32)."""
    pairs, jb, packed = _batch(31, n=8, max_len=60, ga=ga)
    Lq, Ltb = packed[5], packed[6]
    B = len(pairs)
    final_p, done_p, ovf_p, term_p, aux_p, _, end_p, _ = pallas_run_batch(
        *_jax_args(packed), cfg=jb.cfg, B=B, Lq=Lq, Ltb=Ltb, interpret=True)
    ins = te.inputs_from_packed(packed, "cpu")
    final_s, done, overflow, term_cell, aux, end = run_batch(
        *ins[:5], cfg=te.config_from_jax(jb.cfg), Lq=Lq, Ltb=Ltb)
    ok = np.asarray(done_p) & ~np.asarray(ovf_p)
    assert ok.all()
    assert np.array_equal(np.asarray(final_p)[ok], final_s.numpy()[ok])
    assert np.array_equal(np.asarray(term_p)[ok], term_cell.numpy()[ok])
    for a, b in zip(end_p, end):
        assert np.array_equal(np.asarray(a)[ok], b.numpy()[ok])
    paux = np.transpose(np.asarray(aux_p)[..., :B], (0, 1, 3, 2)).astype(
        np.int32)
    taux = aux.numpy()
    for b in np.flatnonzero(ok):
        f = int(final_s[b])
        assert np.array_equal(paux[:, :f + 1, b], taux[:, :f + 1, b]), b


def _check_align_full2(raw, n, ga=True):
    pairs, jb, packed = _batch(41, raw=raw, n=n, ga=ga)
    qb, tbuf, qlen, tlen, toff, Lq, Ltb, qp, tp = packed
    is_packed = tp is not None
    assert is_packed != raw
    seq = np.concatenate([qp if is_packed else qb, tp if is_packed else tbuf],
                         axis=1)
    lens = np.stack([qlen, tlen, toff], axis=1).astype(np.int32)
    jout = _align_full2(jnp.asarray(seq), jnp.asarray(lens), cfg=jb.cfg,
                        B=len(pairs), Lq=Lq, Ltb=Ltb, engine="jax",
                        packed=is_packed, flat=True)
    tout = te.align_full2(torch.from_numpy(seq), torch.from_numpy(lens),
                          cfg=te.config_from_jax(jb.cfg), B=len(pairs),
                          Lq=Lq, Ltb=Ltb, packed=is_packed)
    for key in ("mtb", "lg"):
        a, b = np.asarray(jout[key]), tout[key].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a, b), key
    return pairs, tout


@pytest.mark.parametrize("raw", [False, True], ids=["packed", "raw"])
def test_align_full2_bytes_match_jax(raw):
    """align_full2's "mtb" and "lg" streams are byte-equal to
    wfa_tpu.engine._align_full2(engine="jax", flat=True)."""
    _check_align_full2(raw, 14)


@pytest.mark.parametrize("raw", [False, True], ids=["packed", "raw"])
@pytest.mark.parametrize("mode", ["semi", "full_tokens"])
def test_align_full2_full_token_streams_match_jax(mode, raw, monkeypatch):
    """The full token streams (match runs included) are byte-equal to
    JAX's too: semi-global always ships them, global under
    WFA_EDIT_TOKENS=0, and the port's decode of them equals
    wfa_tpu.cigar's."""
    from wfa_tpu.cigar import AlignmentResult

    if mode == "full_tokens":
        # the JAX gate is read while tracing: a batch size of its own
        # keeps this trace apart from the edit-only one in the jit cache
        monkeypatch.setenv("WFA_EDIT_TOKENS", "0")
    ga = mode == "full_tokens"
    pairs, tout = _check_align_full2(raw, 15, ga=ga)
    _, toks = te.decode_outputs(pairs, tout["mtb"].numpy(),
                                tout["lg"].numpy())
    for (q, t), tk in zip(pairs, toks):
        ref = AlignmentResult.from_device(ga, 0, tk)
        ref.process()
        ours = te.DeviceResult.from_device(ga, 0, tk)
        if not ga:  # as finish_tokens sets them
            ours.lens = (len(q), len(t))
        assert ours.ops == ref.ops and ours.q_end == ref.q_end


def test_config_from_jax_rejects_unported_modes():
    import dataclasses

    from wfa_tpu.engine import EngineConfig

    cfg = EngineConfig(penalties=Penalties(4, 6, 2), adaptive=ADAPTIVE)
    assert te.config_from_jax(cfg) == te.EngineConfig(
        penalties=Penalties(4, 6, 2), adaptive=ADAPTIVE)
    for change in ({"w_win": 32}, {"v_win": 256}):
        with pytest.raises(NotImplementedError):
            te.config_from_jax(dataclasses.replace(cfg, **change))
    # semi-global, the two-phase route's prefix mode and the KW rebased
    # aux are ported
    semi = te.config_from_jax(dataclasses.replace(cfg, global_alignment=False))
    assert not semi.global_alignment
    assert te.config_from_jax(dataclasses.replace(cfg, prefix=True)).prefix
    assert te.config_from_jax(
        dataclasses.replace(cfg, aux_kw=128)).aux_kw == 128


def test_window_origin_and_direct_pack_match_jax():
    """window_origin equals the JAX one and the packed toff is -k0; the
    direct pack (no raw rows) uploads the same bytes."""
    from wfa_tpu.engine import window_origin
    from wfa_tpu_torch import native

    pairs, jb, packed = _batch(51)
    qlen, tlen, toff = packed[2:5]
    for q, t, o in zip(qlen, tlen, toff):
        k0 = te.window_origin(int(q), int(t), 128, True)
        assert k0 == window_origin(int(q), int(t), 128, True) == -int(o)
    direct = te._pack_all(pairs, 128, need_raw=False)
    # the native packer packs straight from the strings, without raw rows
    assert (direct[0] is None) == (native.load() is not None)
    for a, b in zip(direct[2:], packed[2:]):
        assert np.array_equal(a, b)
    for a, b in zip(te._pack_all(pairs, 128), packed):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("raw", [False, True], ids=["packed", "raw"])
def test_numpy_pack_matches_jax(raw, monkeypatch):
    """Without the native packer (no C toolchain), the numpy pack gives
    the same rows and uploads."""
    from wfa_tpu_torch import native

    pairs, jb, packed = _batch(61, raw=raw)
    monkeypatch.setattr(native, "load", lambda: None)
    ours = te._pack_all(pairs, 128)
    assert (ours[8] is None) == raw
    for a, b in zip(ours, packed):
        assert np.array_equal(a, b)


def test_prefix_launch_plan():
    """K3's launch plan (kernel_engine.prefix_plan) at the two-phase
    paths' shapes, Kf 2048 (l=1000, int16 cells; 2048 pairs, and 256 as
    the smoke's 4/6/1 record) and 20,096 (l=10000, int32 cells, 64 pairs),
    at 4/6/2 and 4/6/1 on an H100's 132 SMs: its block shape (threads,
    cluster width), the workspace's place and the shared memory it asks
    for, which never passes what a Hopper block may have (232,448 bytes)
    and agrees with workspace(); the block shape by pairs an SM on either
    side of each threshold; and over every shape, span and place, the
    shared bytes of a plan are the slots, plus the workspace where it lies
    in shared memory."""
    import dataclasses

    from wfa_tpu_torch.kernel_engine import (BLOCK_RESERVED, H100_SMS,
                                             PREFIX_SHAPES,
                                             PREFIX_SHARED_WARPS,
                                             RED_INTS_A_WARP, SHARED_OPTIN,
                                             SM_SHARED, every_prefix_plan,
                                             prefix_block_shape, prefix_plan,
                                             workspace)

    assert SHARED_OPTIN == 232448 and H100_SMS == 132
    assert {prefix_block_shape(kf, B, scratch, H100_SMS)
            for kf in (2048, 4096, 20096) for B in (1, 66, 67, 264, 265,
                                                    2048)
            for scratch in (False, True)} == set(PREFIX_SHAPES)
    base = te.EngineConfig(penalties=Penalties(4, 6, 2), k_win=2048)
    for pen, wm, we in ((Penalties(4, 6, 2), 9, 3),
                        (Penalties(4, 6, 1), 8, 2)):
        # the slots: eight reduction ints for each warp of a pair, then
        # the band slots, rounded up to 4
        red = lambda warps: RED_INTS_A_WARP * warps + 3 * wm + 6 * we
        slots = lambda warps: (red(warps) + 3) // 4 * 4
        for (kf, B, cell16), (threads, scratch) in PREFIX_EXPECTED.items():
            cfg = dataclasses.replace(base, penalties=pen, k_win=kf)
            ints, fits = workspace(cfg, "prefix16" if cell16 else "prefix")
            plan = prefix_plan(cfg, B, cell16, H100_SMS)
            warps = threads[0] * threads[1] // 32
            assert plan == (*threads[:1], 4 * (red(warps) if scratch else
                                               slots(warps) + ints),
                            scratch, ints, threads[1])
            assert plan.shared_bytes <= SHARED_OPTIN
            assert scratch or fits
            if not scratch:  # three blocks an SM, with room to spare
                assert 3 * (plan.shared_bytes + BLOCK_RESERVED) <= (
                    SM_SHARED - 4096)
        # the block shape by pairs an SM, either side of each threshold:
        # in shared memory (int16 cells at Kf 2048), in the scratch (int32
        # cells at Kf 4096 and 20,096: one 1024-thread block a pair while
        # an SM gets at most a pair for every 2048 columns)
        at = lambda kf: dataclasses.replace(base, penalties=pen, k_win=kf)
        for cfg, cell16, shapes in (
                (at(2048), True,
                 ((132, (512, 1)), (133, (256, 1)), (2048, (256, 1)))),
                (at(4096), False, ((66, (1024, 2)), (67, (1024, 1)),
                                   (264, (1024, 1)), (265, (256, 1)))),
                (at(20096), False, ((66, (1024, 2)), (67, (1024, 1)),
                                    (1295, (1024, 1)), (1296, (256, 1))))):
            for B, shape in shapes:
                plan = prefix_plan(cfg, B, cell16, H100_SMS)
                assert ((plan.threads, plan.cluster), plan.scratch) == (
                    shape, not cell16)
        for kf in range(512, 24000, 128):
            cfg = dataclasses.replace(base, penalties=pen, k_win=kf)
            for cell16 in (False, True):
                ints, fits = workspace(cfg, "prefix16" if cell16 else "prefix")
                assert fits == (4 * (slots(PREFIX_SHARED_WARPS) + ints)
                                <= SHARED_OPTIN)
                for t, cl in PREFIX_SHAPES:
                    plan = prefix_plan(cfg, 64, cell16, H100_SMS, t, True,
                                       cl)
                    assert plan.shared_bytes == 4 * red(t * cl // 32)
                    if fits and cl == 1:
                        plan = prefix_plan(cfg, 64, cell16, H100_SMS, t,
                                           False)
                        assert plan.shared_bytes == 4 * (slots(t // 32)
                                                         + ints)
                for B in (64, 256, 2048):
                    plan = prefix_plan(cfg, B, cell16, H100_SMS)
                    assert plan.shared_bytes <= SHARED_OPTIN
                    assert plan.scratch or fits
                # every plan the kernel takes: each shape in the scratch,
                # and in shared memory where its own slots let it fit
                plans = every_prefix_plan(cfg, 64, cell16, H100_SMS)
                assert [p for p in plans if p.scratch] == [
                    prefix_plan(cfg, 64, cell16, H100_SMS, t, True, cl)
                    for t, cl in PREFIX_SHAPES]
                assert [p for p in plans if not p.scratch] == [
                    prefix_plan(cfg, 64, cell16, H100_SMS, t, False)
                    for t, cl in PREFIX_SHAPES
                    if cl == 1 and 4 * (slots(t // 32) + ints)
                    <= SHARED_OPTIN]


# K3's plan at the two-phase paths' shapes: (Kf, pairs, int16 cells) ->
# ((threads, blocks a pair), the workspace in the scratch)
PREFIX_EXPECTED = {(2048, 2048, True): ((256, 1), False),
                   (2048, 256, True): ((256, 1), False),
                   (20096, 64, False): ((1024, 2), True)}


def test_warp_launch_plan():
    """The launch plan of K1-kw and K4 (kernel_engine.warp_plan) in every
    mode (K1-kw's int32 and 16-bit cells, K4's int32 and int16 windows) at
    k_win 256 and 512, 4/6/2 and 4/6/1, on an H100's 132 SMs: as many
    pairs a block as each SM gets, up to 16,
    the workspace in shared memory where an SM holds that many pairs'
    workspaces there, each block with its reserve, and (K1-kw) each SM
    gets more than KW_SCRATCH_PAIRS, else in the scratch, on either side
    of each threshold; the shared bytes, which never pass 232,448 and
    agree with workspace(); the plans at the paths' shapes; and
    every_warp_plan's plans."""
    import dataclasses

    from wfa_tpu_torch.kernel_engine import (BLOCK_RESERVED, H100_SMS,
                                             KW_MODES, KW_SCRATCH_PAIRS,
                                             SHARED_OPTIN, SM_SHARED,
                                             WARP_MODES, WARP_PAIRS,
                                             WARP_SHAPES, every_warp_plan,
                                             warp_plan, warp_slot_ints,
                                             workspace)

    assert SHARED_OPTIN == 232448 and WARP_PAIRS == 16
    base = te.EngineConfig(penalties=Penalties(4, 6, 2), k_win=256)
    for pen, slots in ((Penalties(4, 6, 2), 48), (Penalties(4, 6, 1), 36)):
        for k in (256, 512):
            cfg = dataclasses.replace(base, penalties=pen, k_win=k)
            assert warp_slot_ints(cfg) == slots
            for mode in WARP_MODES:
                ints, fits = workspace(cfg, mode)
                per_pair = 4 * (slots + ints)
                assert fits and per_pair <= SHARED_OPTIN
                for B in (1, 64, 132, 133, 264, 265, 528, 529, 1320, 1321,
                          1848, 1849, 2048, 2112, 2113, 8192):
                    plan = warp_plan(cfg, mode, B, H100_SMS)
                    per_sm = min(WARP_PAIRS, -(-B // H100_SMS))
                    assert plan.pairs == per_sm and plan.ints == ints
                    block = plan.pairs * per_pair
                    held = (plan.pairs * (SM_SHARED // (block
                                                        + BLOCK_RESERVED))
                            if block <= SHARED_OPTIN else 0)
                    assert plan.scratch == (held < per_sm or (
                        mode in KW_MODES and per_sm <= KW_SCRATCH_PAIRS))
                    assert plan.shared_bytes == 4 * plan.pairs * (
                        slots + (0 if plan.scratch else ints))
                    assert plan.shared_bytes <= SHARED_OPTIN
                # at 792 pairs the plan's own 6 pairs a block join
                plans = every_warp_plan(cfg, mode, 792, H100_SMS)
                shapes = sorted({*WARP_SHAPES, 6})
                assert [p.pairs for p in plans if p.scratch] == shapes
                assert [p.pairs for p in plans if not p.scratch] == [
                    n for n in shapes if n * per_pair <= SHARED_OPTIN]
    for (pen, mode, k, B), want in WARP_EXPECTED.items():
        plan = warp_plan(dataclasses.replace(base, penalties=Penalties(*pen),
                                             k_win=k), mode, B, H100_SMS)
        assert (plan.pairs, plan.scratch) == want, (pen, mode, k, B)


# the plan of K1-kw and K4 at the paths' shapes and either side of each
# threshold: (penalties, mode, k_win, pairs) -> (pairs a block, the
# workspace in the scratch).  K1-kw: the l=4000 path's
# 2048 pairs (k_win 256, 16-bit cells: shared memory at 16 pairs an SM),
# 256 at the tier-1 window; in the scratch up to 8 pairs an SM, past it in
# shared memory while an SM holds them there (16-bit cells: 10 at k_win
# 512; int32 ones: 10 at 256).  K4: int16 windows at k_win 256 (l=1000,
# 2048 pairs; the smoke's 256 pairs at 4/6/1) hold 16 pairs an SM in
# shared memory, int16 at 512 (tier 1) and int32 at 256 (l=10000, 64
# pairs) 14
WARP_EXPECTED = {((4, 6, 2), "kw16", 256, 2048): (16, False),
                 ((4, 6, 2), "kw16", 512, 256): (2, True),
                 ((4, 6, 2), "kw16", 256, 132): (1, True),
                 ((4, 6, 2), "kw16", 256, 133): (2, True),
                 ((4, 6, 2), "kw16", 256, 1056): (8, True),
                 ((4, 6, 2), "kw16", 256, 1057): (9, False),
                 ((4, 6, 2), "kw16", 512, 1320): (10, False),
                 ((4, 6, 2), "kw16", 512, 1321): (11, True),
                 ((4, 6, 2), 3, 256, 1320): (10, False),
                 ((4, 6, 2), 3, 256, 1321): (11, True),
                 ((4, 6, 2), "resume16", 256, 2048): (16, False),
                 ((4, 6, 2), "resume16", 256, 256): (2, False),
                 ((4, 6, 2), "resume", 256, 64): (1, False),
                 ((4, 6, 1), "resume16", 256, 256): (2, False),
                 ((4, 6, 1), "resume16", 256, 528): (4, False),
                 ((4, 6, 1), "resume16", 256, 529): (5, False),
                 ((4, 6, 1), "resume16", 256, 2048): (16, False),
                 ((4, 6, 2), "resume16", 512, 1848): (14, False),
                 ((4, 6, 2), "resume16", 512, 1849): (15, True),
                 ((4, 6, 2), "resume", 256, 1849): (15, True)}


def test_workspace_placement_and_size():
    """The score loop's workspace: its int32 count (the windows, the
    staged rows, three ballot words per 32 columns but in the warp shape
    of K1-kw and K4, rounded up to 4; csrc/score_loop.cu workspace_ints)
    and whether it fits shared memory, by shape alone: in 48 KB after the
    reduction and band slots (K1, K1-long), or in the warp shape one
    pair's band slots and workspace in the 227 KB a block opts in to; the
    batch memory model counts it."""
    import dataclasses

    from wfa_tpu_torch.device_backtrace import iter_capacity
    from wfa_tpu_torch.kernel_engine import (RED_INTS_A_WARP, SHARED_BYTES,
                                             SHARED_OPTIN, STAGE_ROWS, WARPS,
                                             warp_slot_ints, workspace)
    from wfa_tpu_torch.pipeline import batch_bytes_per_pair

    cfg = te.EngineConfig(penalties=Penalties(4, 6, 2), k_win=128, s_cap=640)
    at = lambda k: dataclasses.replace(cfg, k_win=k)  # noqa: E731
    # K1 at the main path's window: 9 + 3 + 3 rows of 128 columns
    assert workspace(cfg, 0) == (15 * 128 + 12, True)
    # K1-long at 384 and K1-kw at 256: two staged rows of each plane (the
    # warp shape K1-kw without ballot words)
    assert STAGE_ROWS[2] == STAGE_ROWS[3] == 6
    assert workspace(at(384), 2) == (21 * 384 + 36, True)
    assert workspace(at(256), 3) == (21 * 256, True)
    # K3 at the full span of l=1000 fits the 227 KB it opts in to (at
    # l=10000 it goes to the scratch), K4's narrow window goes to shared
    # memory
    assert workspace(at(2048), "prefix") == (18 * 2048 + 192, True)
    assert workspace(at(20096), "prefix") == (18 * 20096 + 1884, False)
    # its int16 cells, the ballot words after whole 16-byte words of them
    assert workspace(at(2048), "prefix16") == (9 * 2048 + 192, True)
    assert workspace(at(100), "prefix16") == (
        (18 * 100 * 2 + 15) // 16 * 4 + 12, True)
    # K1-kw's 16-bit window and staged cells, no ballot words
    assert workspace(at(256), "kw16") == (21 * 256 // 2, True)
    # K4's int32 and int16 windows, no ballot words
    assert workspace(at(256), "resume") == (15 * 256, True)
    assert workspace(at(256), "resume16") == (15 * 256 // 2, True)
    assert workspace(at(100), "resume16") == ((15 * 100 * 2 + 15) // 16 * 4,
                                              True)
    # an odd width rounds up to 4 ints
    assert workspace(at(100), 0) == (15 * 100 + 12, True)
    assert workspace(at(101), 0) == (15 * 101 + 12 + 1, True)
    assert workspace(at(101), 3) == (21 * 101 + 3, True)
    # the limit, with the slots: reduction, then 3 WM + 6 WE, rounded to 4
    slots = (RED_INTS_A_WARP * WARPS + 3 * 9 + 6 * 3 + 3) // 4 * 4
    for mode, (inside, outside) in ((0, (768, 896)), (2, (512, 640))):
        for k, shared in ((inside, True), (outside, False)):
            ints, sh = workspace(at(k), mode)
            assert sh is shared
            assert (4 * (slots + ints) <= SHARED_BYTES) is shared
    # the warp shape: one pair's band slots (3 WM + 6 WE, rounded to 4)
    # and workspace within the 227 KB
    assert warp_slot_ints(cfg) == 48
    for mode, (inside, outside) in ((3, (2688, 2816)),
                                    ("kw16", (5504, 5632)),
                                    ("resume", (3840, 3968)),
                                    ("resume16", (7680, 7808))):
        for k, shared in ((inside, True), (outside, False)):
            ints, sh = workspace(at(k), mode)
            assert sh is shared
            assert (4 * (48 + ints) <= SHARED_OPTIN) is shared
    # wide penalties deepen the windows
    wide = dataclasses.replace(cfg, penalties=Penalties(9, 13, 5))
    assert workspace(dataclasses.replace(wide, k_win=384), 0) == (
        31 * 384 + 36, True)
    assert workspace(dataclasses.replace(wide, k_win=512), 0) == (
        31 * 512 + 48, False)
    # the memory model counts the workspace as scratch wherever it goes
    long = dataclasses.replace(cfg, k_win=384, s_cap=27648)
    ns = 2 * iter_capacity(27648, Penalties(4, 6, 2)) + 5
    assert batch_bytes_per_pair(long, 50000, "long") == (
        6 * 27648 * 384 + 4 * 27648 + 4 * (21 * 384 + 36) + 40 * ns
        + 4 * (2 * 50000 + 384))
