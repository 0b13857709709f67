"""PyTorch port vs the JAX package: global reads longer than 4096 bases.

The long-read score loop (``engine.run_batch_long_plain``, the plain
version of K1-long) against the TPU long-read kernel in interpret mode
(``wfa_tpu.pallas_longread.pallas_run_batch``), the backtrace over its
value-rebased int16 aux, the ``engine="long"`` byte streams, the raw
outputs of a token stream over 2**16 slots, the int16 guard, and the
pipeline's long-read ladder against the oracle.  Every output is an
integer: the tolerance is exact equality.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wfa_tpu import AdaptiveReductionOption, Options, OracleAligner, Penalties
from wfa_tpu import device_backtrace as jdb
from wfa_tpu.datagen import generate_pairs
from wfa_tpu.engine import BatchAligner as JaxBatchAligner
from wfa_tpu.engine import _align_full2
from wfa_tpu.pallas_longread import pallas_run_batch as pallas_run_long
from wfa_tpu_torch import engine as te
from wfa_tpu_torch.device_backtrace import device_backtrace
from wfa_tpu_torch.kernel_engine import run_batch_long
from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

torch.set_num_threads(2)

ADAPTIVE = AdaptiveReductionOption(10, 50, 1)
FIELDS = ("score", "q_begin", "q_end", "t_begin", "t_end", "align_len",
          "matches", "gaps", "gap_regions")
PENALTIES = {"4-6-2": Penalties(4, 6, 2), "2-3-1": Penalties(2, 3, 1)}


def _assert_oracle(pairs, results, penalties, adaptive, ga=True):
    oracle = OracleAligner(penalties, Options(ga), adaptive)
    assert len(results) == len(pairs)
    for (q, t), res in zip(pairs, results):
        ref = oracle.align(q, t)
        assert res.cigar(False) == ref.cigar(False), (q[:40], t[:40])
        for f in FIELDS:
            assert getattr(res, f) == getattr(ref, f), f


@functools.lru_cache(maxsize=None)
def _long_batch(pen_id):
    """4 pairs of l=300 at k_win 128, s_cap 256, 10/50/1, through the TPU
    long-read kernel (interpret mode) and through run_batch_long_plain."""
    p = PENALTIES[pen_id]
    jb = JaxBatchAligner(p, Options(True), ADAPTIVE, k_win=128, s_cap=256,
                         engine="jax")
    pairs = generate_pairs(4, 300, 0.05, seed=3)
    packed = jb._pack_all(pairs)
    Lq, Ltb = packed[5], packed[6]
    jout = pallas_run_long(*(jnp.asarray(a) for a in packed[:5]), cfg=jb.cfg,
                           B=len(pairs), Lq=Lq, Ltb=Ltb, interpret=True)
    ins = te.inputs_from_packed(packed, "cpu")
    tout = run_batch_long(*ins[:5], cfg=te.config_from_jax(jb.cfg), Lq=Lq,
                          Ltb=Ltb)
    return jb.cfg, packed, jout, tout


@pytest.mark.parametrize("pen_id", list(PENALTIES))
def test_run_batch_long_plain_matches_pallas_longread(pen_id):
    """final_s, done, overflow and term_cell of every pair; the int16 aux
    rows <= final_s and aux_base[:B, :final_s + 1] of done pairs (the JAX
    aux is [3, S, Bp, K] and aux_base [Bp, S], padded to its block)."""
    cfg, packed, jout, tout = _long_batch(pen_id)
    B = len(packed[2])
    final_s, done, overflow, term_cell, aux, aux_base = tout
    for a, b in zip(jout[:4], tout[:4]):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert aux.dtype == torch.int16 and aux_base.dtype == torch.int32
    assert aux.shape == (3, cfg.s_cap, B, cfg.k_win)
    assert aux_base.shape == (B, cfg.s_cap)
    ok = done.numpy() & ~overflow.numpy()
    assert ok.all()
    jaux = np.asarray(jout[4])[:, :, :B]
    jbase = np.asarray(jout[6])[:B]
    for b in range(B):
        f = int(final_s[b])
        assert np.array_equal(jaux[:, :f + 1, b], aux.numpy()[:, :f + 1, b])
        assert np.array_equal(jbase[b, :f + 1], aux_base.numpy()[b, :f + 1])
    # rows are rebased: some base is above 0, every stored offset small
    assert (jbase[:, :int(final_s.max()) + 1] > 0).any()
    assert int(aux.max()) < 8 * 256


@pytest.mark.parametrize("token_shift", [12, 28])
def test_device_backtrace_rebased_matches_jax(token_shift):
    """device_backtrace(aux_base=...) equals JAX's on the TPU long-read
    kernel's own outputs, with edit-only and full token codes."""
    cfg, packed, jout, _ = _long_batch("4-6-2")
    qlen, tlen, toff = (packed[i].astype(np.int32) for i in (2, 3, 4))
    B = len(qlen)
    final_s, done, overflow, term_cell, aux, b_stride, aux_base = jout
    ok = np.asarray(done) & ~np.asarray(overflow)
    for split in (True, False):
        kw = dict(penalties=cfg.penalties, S=cfg.s_cap, K=cfg.k_win,
                  token_shift=token_shift, split_ext_codes=split)
        j = jdb.device_backtrace(
            aux, term_cell, jnp.asarray(-toff), final_s,
            jnp.asarray(tlen - qlen), jnp.asarray(qlen), jnp.asarray(tlen),
            jnp.asarray(ok), global_alignment=True, b_stride=b_stride,
            aux_base=aux_base, **kw)
        t = device_backtrace(
            *(torch.from_numpy(np.array(a)) for a in (
                np.asarray(aux)[:, :, :B], term_cell, -toff, final_s,
                tlen - qlen, qlen, tlen, ok)),
            aux_base=torch.from_numpy(np.array(np.asarray(aux_base)[:B])),
            return_iters=True, **kw)
        for a, b in zip(j[:3], t[:3]):
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())
        # the JAX loop's trip count is the most iterations a pair ran
        assert int(j[3]) == int(t[3].max())


def _long_pairs(extra):
    """Two pairs of ~4300 bases with few edits (a few dozen scores: the
    28-bit tokens and long-run splicing at little cost), plus ``extra``
    identical pairs of 16,500 bases (score 0, Lq + Ltb > 32000: 4-byte
    meta)."""
    pairs = generate_pairs(2, 4300, 0.002, seed=5)
    q = generate_pairs(1, 16500, 0.0, seed=6)[0][0]
    return pairs + [(q, q)] * extra


@pytest.mark.parametrize("mode", ["edit", "full_tokens"])
def test_align_full2_long_bytes_match_jax(mode, monkeypatch):
    """align_full2(engine="long") "mtb" and "lg" streams are byte-equal to
    JAX's _align_full2(engine="pallas_long", flat=True), and decode to the
    oracle's results."""
    if mode == "full_tokens":
        # the JAX gate is read while tracing: a batch size of its own
        # keeps this trace apart from the edit-only one in the jit cache
        monkeypatch.setenv("WFA_EDIT_TOKENS", "0")
    pairs = _long_pairs(1 if mode == "edit" else 2)
    p = Penalties(4, 6, 2)
    jb = JaxBatchAligner(p, Options(True), ADAPTIVE, k_win=256, s_cap=128,
                         engine="jax")
    qb, tbuf, qlen, tlen, toff, Lq, Ltb, qp, tp = jb._pack_all(pairs)
    assert max(Lq, Ltb) >= 4096 and Lq + Ltb > 32000
    seq = np.concatenate([qp, tp], axis=1)
    lens = np.stack([qlen, tlen, toff], axis=1).astype(np.int32)
    jout = _align_full2(jnp.asarray(seq), jnp.asarray(lens), cfg=jb.cfg,
                        B=len(pairs), Lq=Lq, Ltb=Ltb, engine="pallas_long",
                        packed=True, flat=True)
    tout = te.align_full2(torch.from_numpy(seq), torch.from_numpy(lens),
                          cfg=te.config_from_jax(jb.cfg), B=len(pairs),
                          Lq=Lq, Ltb=Ltb, packed=True, engine="long")
    assert sorted(tout) == ["lg", "mtb"]
    for key in ("mtb", "lg"):
        a, b = np.asarray(jout[key]), tout[key].numpy()
        assert a.dtype == b.dtype == (np.int32 if key == "lg" else np.uint8)
        assert a.shape == b.shape and np.array_equal(a, b), key
    meta, toks = te.decode_outputs(pairs, tout["mtb"].numpy(),
                                   tout["lg"].numpy())
    if mode == "full_tokens":  # the 16,500-base match run is spliced
        assert meta[-1, te.M_LONG] == 1
    edit = mode == "edit"
    res = [te.DeviceResult.from_device(True, int(m[te.M_SCORE]),
                                       (tk, q, t) if edit else tk)
           for (q, t), m, tk in zip(pairs, meta, toks)]
    _assert_oracle(pairs, res, p, ADAPTIVE)


def test_raw_outputs_match_jax():
    """At an s_cap whose token stream passes 2**16 slots, _finish_outputs
    ships the raw {"meta", "tok0", "buf", "tail"} (full tokens, the trim
    column the chase's iteration count), equal to JAX's; the host joins
    them into results equal to the oracle."""
    p = Penalties(4, 6, 2)
    S = 65528
    pairs = generate_pairs(3, 60, 0.05, seed=8)
    jb = JaxBatchAligner(p, Options(True), ADAPTIVE, k_win=32, s_cap=S,
                         engine="jax")
    qb, tbuf, qlen, tlen, toff, Lq, Ltb, qp, tp = jb._pack_all(pairs)
    assert not te._token_plan(S, p, Lq, Ltb)[1]
    seq = np.concatenate([qp, tp], axis=1)
    lens = np.stack([qlen, tlen, toff], axis=1).astype(np.int32)
    jout = _align_full2(jnp.asarray(seq), jnp.asarray(lens), cfg=jb.cfg,
                        B=len(pairs), Lq=Lq, Ltb=Ltb, engine="jax",
                        packed=True, flat=True)
    tout = te.align_full2(torch.from_numpy(seq), torch.from_numpy(lens),
                          cfg=te.config_from_jax(jb.cfg), B=len(pairs),
                          Lq=Lq, Ltb=Ltb, packed=True)
    assert sorted(tout) == sorted(jout) == ["buf", "meta", "tail", "tok0"]
    for key in jout:
        a, b = np.asarray(jout[key]), tout[key].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    assert int(tout["meta"][0, te.M_TRIM]) > 0
    eng = te.BatchAligner(p, Options(True), ADAPTIVE, k_win=32, s_cap=S,
                          device="cpu")
    res = eng.align_batch(pairs, fallback=False)
    assert all(isinstance(r, te.DeviceResult) for r in res)
    _assert_oracle(pairs, res, p, ADAPTIVE)


def _guard_pair():
    """With reduction off, the score-8 row of this pair spreads past what
    an int16 cell holds: diagonal 0 runs a 4,200-base stretch shared only
    there (offset0 ~4,200), while diagonals -1 and +1 open from the
    score-0 seed near offset 1."""
    rng = np.random.default_rng(12)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    run = acgt[rng.integers(0, 4, 4200)].tobytes()
    tail = acgt[rng.integers(0, 4, 30)].tobytes()
    return b"AG" + run + b"T" + tail, b"AC" + run + b"G" + tail


def test_int16_guard_overflows_to_oracle():
    p = Penalties(4, 6, 2)
    pairs = [_guard_pair()] + generate_pairs(2, 300, 0.01, seed=9)
    cfg = te.EngineConfig(penalties=p, adaptive=None, k_win=64, s_cap=64)
    ins = te.inputs_from_packed(te._pack_all(pairs, 64), "cpu")
    plain = te.run_batch_plain(*ins[:5], cfg=cfg, Lq=ins[5], Ltb=ins[6])
    final_s, done, overflow, term_cell, _, _ = te.run_batch_long_plain(
        *ins[:5], cfg=cfg, Lq=ins[5], Ltb=ins[6])
    # the int32 loop finishes the pair at score 8; its rows do not fit
    assert bool(plain[1][0]) and int(plain[0][0]) == 8
    assert bool(overflow[0]) and not bool(done[0])
    assert int(final_s[0]) == int(term_cell[0]) == 0
    # the other pairs are untouched
    for a, b in zip(plain[:4], (final_s, done, overflow, term_cell)):
        assert torch.equal(a[1:], b[1:])
    eng = te.BatchAligner(p, Options(True), None, k_win=64, s_cap=64,
                          engine="long", device="cpu")
    assert eng.align_batch(pairs, fallback=False)[0] is None
    _assert_oracle(pairs, eng.align_batch(pairs, fallback=True), p, None)


def test_pipeline_long_reads_match_oracle():
    """Global pairs of l=4500-6000 through AlignmentPipeline on the CPU:
    served by "long" engines at one k_win on every tier, equal to the
    oracle.  A second call with a noisier pair overflows the fitted
    tier-0 score cap and retries at tier 1, k_win unchanged."""
    p = Penalties(4, 6, 2)
    pairs = (generate_pairs(2, 4500, 0.01, seed=41)
             + generate_pairs(1, 6000, 0.005, seed=42))
    pipe = AlignmentPipeline(PipelineConfig(p, Options(True), ADAPTIVE,
                                            batch_size=4, device="cpu"))
    _assert_oracle(pairs, pipe.align_all(pairs), p, ADAPTIVE)
    assert pipe.served[0] == len(pairs)
    noisy = pairs + generate_pairs(1, 4500, 0.04, seed=43)
    _assert_oracle(noisy, pipe.align_all(noisy), p, ADAPTIVE)
    assert pipe.served[1] == 1 and pipe.served["oracle"] == 0
    assert len(pipe._engines) == 3
    assert {(k, e) for k, _, e in pipe._engines} == {(256, "long")}


def test_tier_ladder_matches_jax():
    """The window ladder equals wfa_tpu.pipeline's: widening only up to
    4096 bases, the long-read engine for global wf-adaptive buckets above
    (JAX's "pallas_long"), K1-kw exactly where JAX gives "auto:kw{k_win}"
    (longest read in (4095 - k_win, 4096]), the same tier-0 score cap.
    JAX's last tier takes its XLA engine for long reads, to finish pairs
    its kernel's table window outran; K1-long has no such window and
    serves it too.  JAX clamps s_cap by a TPU memory model
    (pipeline.py:171-175), which binds at l=100000 and for full-span
    windows; the port has its own."""
    from wfa_tpu.pipeline import AlignmentPipeline as JaxPipeline
    from wfa_tpu.pipeline import PipelineConfig as JaxConfig

    kw_seen = 0
    for adaptive in (ADAPTIVE, None):
        args = (Penalties(4, 6, 2), Options(True), adaptive)
        ours = AlignmentPipeline(PipelineConfig(*args, device="cpu"))
        ref = JaxPipeline(JaxConfig(*args, n_devices=1))
        for length in (1000, 3839, 3840, 4000, 4096, 4500, 50000, 100000):
            for tier in (0, 1, 2):
                k, s, _, engine = ours._tier_caps(length, length, tier)[:4]
                jk, js, _, _, jengine = ref._tier_caps(length, length,
                                                       tier)[:5]
                assert k == jk, (length, tier)
                long = (adaptive is not None and length > 4096)
                assert (engine == "long") == long, (length, tier)
                if tier < 2:
                    assert long == (jengine == "pallas_long")
                assert (engine == f"auto:kw{k}") == (
                    jengine == f"auto:kw{jk}"), (length, tier, engine)
                kw_seen += engine.startswith("auto:kw")
                if tier == 0 and adaptive is not None and length <= 50000:
                    assert s == js, (length, tier)
    assert kw_seen == 3  # tier 0 at 3840, 4000 and 4096 bases


def test_long_engine_guards():
    """engine="long" runs global alignment only; semi-global reads over
    4096 bases are served (the two-phase route, engine "semi2:<S0>") and
    equal the oracle."""
    p = Penalties(4, 6, 2)
    semi = te.BatchAligner(p, Options(False), ADAPTIVE, engine="long",
                           device="cpu")
    with pytest.raises(ValueError):
        semi.align_batch([(b"ACGT", b"ACGA")])
    semi2 = te.BatchAligner(p, Options(False), ADAPTIVE, k_win=256,
                            s_cap=256, engine="semi2:64", device="cpu")
    long = [(b"A" * 4097, b"A" * 4097)]
    res = semi2.align_batch(long, fallback=False)
    assert isinstance(res[0], te.DeviceResult)
    _assert_oracle(long, res, p, ADAPTIVE, ga=False)
    with pytest.raises(ValueError):
        te.BatchAligner(p, Options(True), ADAPTIVE, engine="pallas",
                        device="cpu")
    cfg = te.EngineConfig(penalties=p, global_alignment=False)
    ins = te.inputs_from_packed(
        te._pack_all([(b"ACGT", b"ACGA")], 128, global_alignment=False),
        "cpu")
    with pytest.raises(ValueError):
        run_batch_long(*ins[:5], cfg=cfg, Lq=ins[5], Ltb=ins[6])
