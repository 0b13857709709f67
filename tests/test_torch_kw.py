"""PyTorch port vs the JAX package: the score loop's KW rebased-aux mode.

The port's counterpart of ``tests/test_rebase_aux.py``.  The plain version
of K1-kw (``engine.run_batch_kw_plain``) against the TPU kernel with
``cfg.aux_kw`` in interpret mode (``wfa_tpu.pallas_engine
.pallas_run_batch``) at the three ``test_rebase_aux_bitexact`` cases, each
of which shifts the row window (``cb > 0``); the backtrace over that aux
through its sbase words against JAX's ``device_backtrace(aux_sbase=...)``;
``BatchAligner(engine="pallas:kw<KW>")`` against the oracle and JAX's
served set; the wide-band escape; the value-only long-offset case; the
engine strings, guards and routing.  Every output is an integer: the
tolerance is exact equality.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wfa_tpu import AdaptiveReductionOption, Options, OracleAligner, Penalties
from wfa_tpu import device_backtrace as jdb
from wfa_tpu.datagen import generate_pairs
from wfa_tpu.engine import BatchAligner as JaxBatchAligner
from wfa_tpu.pallas_engine import pallas_run_batch
from wfa_tpu_torch import engine as te
from wfa_tpu_torch.device_backtrace import device_backtrace
from wfa_tpu_torch.kernel_engine import run_batch_kw
from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

torch.set_num_threads(2)

PEN = Penalties(4, 6, 2)
GLOB = Options(True)
ADA = AdaptiveReductionOption(10, 50, 1)
FIELDS = ("score", "q_begin", "q_end", "t_begin", "t_end", "align_len",
          "matches", "gaps", "gap_regions")
# (l, e, KW, k_win, s_cap): test_rebase_aux_bitexact's cases; each shifts
# the row window (cb > 0) on some row
CASES = {"l400_e10": (400, 0.10, 256, 512, 512),
         "l400_e20": (400, 0.20, 256, 512, 1024),
         "l300_kw128": (300, 0.05, 128, 256, 384)}


def _assert_oracle(pairs, results, adaptive=ADA):
    oracle = OracleAligner(PEN, GLOB, adaptive)
    for (q, t), res in zip(pairs, results):
        ref = oracle.align(q, t)
        assert res.cigar(False) == ref.cigar(False), (q[:40], t[:40])
        for f in FIELDS:
            assert getattr(res, f) == getattr(ref, f), f


@functools.lru_cache(maxsize=None)
def _kw_batch(case):
    """4 pairs of the case through the TPU kernel with aux_kw (interpret
    mode, at sizes where it streams no table window, so its served set is
    the port's) and through run_batch_kw (CPU tensors: the plain
    version)."""
    l, e, kw, k_win, s_cap = CASES[case]
    jb = JaxBatchAligner(PEN, GLOB, ADA, k_win=k_win, s_cap=s_cap,
                         engine=f"pallas:kw{kw}")
    assert jb.cfg.aux_kw == kw
    pairs = generate_pairs(4, l, e, seed=21)
    packed = jb._pack_all(pairs)
    Lq, Ltb = packed[5], packed[6]
    jout = pallas_run_batch(*(jnp.asarray(a) for a in packed[:5]), cfg=jb.cfg,
                            B=len(pairs), Lq=Lq, Ltb=Ltb, interpret=True)
    ins = te.inputs_from_packed(packed, "cpu")
    tout = run_batch_kw(*ins[:5], cfg=te.config_from_jax(jb.cfg), Lq=Lq,
                        Ltb=Ltb)
    return jb.cfg, pairs, packed, jout, tout


@pytest.mark.parametrize("case", list(CASES))
def test_run_batch_kw_plain_matches_pallas(case):
    """The served set; final_s and term_cell of served pairs; their int16
    aux rows and sbase words <= final_s (JAX's aux is [3, S, KW, Bp],
    sbase [S, Bp])."""
    cfg, pairs, _, jout, tout = _kw_batch(case)
    B, KW = len(pairs), cfg.aux_kw
    final_s, done, overflow, term_cell, aux, sbase = tout
    assert aux.dtype == torch.int16 and sbase.dtype == torch.int32
    assert aux.shape == (3, cfg.s_cap, B, KW) and sbase.shape == (cfg.s_cap, B)
    ok_j = np.asarray(jout[1]) & ~np.asarray(jout[2])
    ok = (done & ~overflow).numpy()
    assert np.array_equal(ok_j, ok) and ok.sum() >= 3
    for a, b in ((jout[0], final_s), (jout[3], term_cell)):
        assert np.array_equal(np.asarray(a)[ok], b.numpy()[ok])
    jaux = np.transpose(np.asarray(jout[4])[..., :B], (0, 1, 3, 2))
    jsb = np.asarray(jout[7])[:, :B]
    for b in np.flatnonzero(ok):
        f = int(final_s[b])
        assert np.array_equal(jaux[:, :f + 1, b], aux.numpy()[:, :f + 1, b])
        assert np.array_equal(jsb[:f + 1, b], sbase.numpy()[:f + 1, b])
    # the band drifts past 32 columns: the window shifts (cb > 0)
    assert max(int((sbase[:int(final_s[b]) + 1, b] & 31).max())
               for b in np.flatnonzero(ok)) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_device_backtrace_sbase_matches_jax(case):
    """device_backtrace(aux_sbase=...) equals JAX's on the TPU kernel's own
    outputs: tokens (edit-only codes) and the chase's trip count."""
    cfg, pairs, packed, jout, _ = _kw_batch(case)
    qlen, tlen, toff = (packed[i].astype(np.int32) for i in (2, 3, 4))
    B = len(pairs)
    final_s, done, overflow, term_cell, aux, Bp, _, sbase = jout
    ok = np.asarray(done) & ~np.asarray(overflow)
    kw = dict(penalties=cfg.penalties, S=cfg.s_cap, K=cfg.aux_kw,
              token_shift=12, split_ext_codes=True)
    j = jdb.device_backtrace(
        aux, term_cell, jnp.asarray(-toff), final_s, jnp.asarray(tlen - qlen),
        jnp.asarray(qlen), jnp.asarray(tlen), jnp.asarray(ok),
        global_alignment=True, b_stride=Bp, pairs_on_lanes=True,
        aux_sbase=sbase, **kw)
    taux = np.ascontiguousarray(
        np.transpose(np.asarray(aux)[..., :B], (0, 1, 3, 2)))
    t = device_backtrace(
        *(torch.from_numpy(np.array(a)) for a in (
            taux, term_cell, -toff, final_s, tlen - qlen, qlen, tlen, ok)),
        aux_sbase=torch.from_numpy(np.ascontiguousarray(
            np.asarray(sbase)[:, :B])), return_iters=True, **kw)
    for a, b in zip(j[:3], t[:3]):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())
    assert int(j[3]) == int(t[3].max())


@pytest.mark.parametrize("case", list(CASES))
def test_batch_aligner_kw_matches_oracle(case):
    """BatchAligner(engine="pallas:kw<KW>") on the CPU: every served result
    equals the oracle, and its None pattern is the TPU kernel's."""
    cfg, pairs, _, jout, _ = _kw_batch(case)
    _, _, kw, k_win, s_cap = CASES[case]
    eng = te.BatchAligner(PEN, GLOB, ADA, k_win=k_win, s_cap=s_cap,
                          engine=f"pallas:kw{kw}", device="cpu")
    assert eng.engine == "kw" and eng.cfg.aux_kw == kw
    res = eng.align_batch(pairs, fallback=False)
    ok_j = np.asarray(jout[1]) & ~np.asarray(jout[2])
    assert [r is not None for r in res] == ok_j.tolist()
    served = [i for i, r in enumerate(res) if r is not None]
    _assert_oracle([pairs[i] for i in served], [res[i] for i in served])


def test_kw_wide_band_escapes():
    """Without wf-adaptive trimming the band outgrows a 128-column window:
    every pair escapes (None), none returns a wrong result; with the
    fallback all equal the oracle."""
    ada_off = AdaptiveReductionOption(10, 10 ** 6, 1)  # never trims
    eng = te.BatchAligner(PEN, GLOB, ada_off, k_win=256, s_cap=512,
                          engine="pallas:kw128", device="cpu")
    pairs = generate_pairs(3, 300, 0.10, seed=5)
    assert all(r is None for r in eng.align_batch(pairs, fallback=False))
    _assert_oracle(pairs, eng.align_batch(pairs), ada_off)


def test_kw_value_only_long_offsets():
    """KW == k_win past the 13-bit offset limit (l=4300): pure value
    rebase, int16 cells, results equal the oracle."""
    eng = te.BatchAligner(PEN, GLOB, ADA, k_win=128, s_cap=768,
                          engine="auto:kw128", device="cpu")
    pairs = generate_pairs(2, 4300, 0.02, seed=9)
    res = eng.align_batch(pairs, fallback=False)
    served = [i for i, r in enumerate(res) if r is not None]
    assert served
    _assert_oracle([pairs[i] for i in served], [res[i] for i in served])


def test_config_from_jax_round_trips_aux_kw():
    from wfa_tpu.engine import EngineConfig

    cfg = EngineConfig(penalties=PEN, adaptive=ADA, k_win=512, aux_kw=256)
    ours = te.config_from_jax(cfg)
    assert ours.aux_kw == 256
    assert ours == dataclasses.replace(te.EngineConfig(
        penalties=PEN, adaptive=ADA, k_win=512), aux_kw=256)
    jb = JaxBatchAligner(PEN, GLOB, ADA, k_win=256, engine="pallas:kw512")
    assert te.config_from_jax(jb.cfg).aux_kw == jb.cfg.aux_kw == 256


def test_kw_engine_guards():
    """Both engine strings parse to aux_kw = min(KW, k_win); K1-kw is
    global only; the TPU kernel's asserts are ValueErrors."""
    pairs = [(b"ACGTACGTAC", b"ACGTTCGTAC")]
    for engine in ("auto:kw256", "pallas:kw256"):
        eng = te.BatchAligner(PEN, GLOB, ADA, k_win=128, engine=engine,
                              device="cpu")
        assert eng.engine == "kw" and eng.cfg.aux_kw == 128
        _assert_oracle(pairs, eng.align_batch(pairs, fallback=False))
        semi = te.BatchAligner(PEN, Options(False), ADA, engine=engine,
                               device="cpu")
        with pytest.raises(ValueError):
            semi.align_batch(pairs)
    # KW not a multiple of 128, and a row base past sbase's 5 bits
    for k_win, engine in ((256, "auto:kw64"), (1280, "auto:kw128")):
        eng = te.BatchAligner(PEN, GLOB, ADA, k_win=k_win, engine=engine,
                              device="cpu")
        with pytest.raises(ValueError):
            eng.align_batch(pairs)


def test_pipeline_kw_route_matches_oracle():
    """Global pairs whose longest read lies in (4095 - k_win, 4096] take
    K1-kw at tier 0 ("auto:kw256"), as wfa_tpu.pipeline routes them, and
    equal the oracle."""
    pairs = generate_pairs(2, 3950, 0.003, seed=31)
    assert all(3840 <= max(len(q), len(t)) <= 4096 for q, t in pairs)
    pipe = AlignmentPipeline(PipelineConfig(PEN, GLOB, ADA, batch_size=4,
                                            device="cpu"))
    _assert_oracle(pairs, pipe.align_all(pairs))
    assert pipe.served[0] == len(pairs)
    assert [e for _, _, e in pipe._engines] == ["auto:kw256"]
