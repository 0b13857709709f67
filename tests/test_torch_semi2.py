"""PyTorch port vs the JAX package: the two-phase semi-global route.

The phase-1 exports of ``wfa_tpu_torch.semi2.prefix_export_plain`` (the
plain version of K3) against ``wfa_tpu.semi2.prefix_export_impl`` (XLA)
and ``prefix_export_kernel_impl`` (Pallas, interpret mode); phase 2 (the
plain resume, K2 over both aux tensors, compaction) against
``wfa_tpu.semi2.phase2``'s byte streams; ``BatchAligner(engine=
"semi2:<S0>")`` against JAX's; the semi-global tier ladder against
``wfa_tpu.pipeline``'s; and the pipeline against the oracle.  Inputs come
from ``generate_pairs`` with a seed; every output is an integer, so the
tolerance is exact equality.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wfa_tpu import AdaptiveReductionOption, Options, OracleAligner, Penalties
from wfa_tpu.datagen import generate_pairs
from wfa_tpu.engine import BatchAligner as JaxBatchAligner
from wfa_tpu.semi2 import phase2 as jax_phase2
from wfa_tpu.semi2 import prefix_export_impl, prefix_export_kernel_impl
from wfa_tpu_torch import engine as te
from wfa_tpu_torch import semi2 as ts
from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

torch.set_num_threads(2)

SEMI = Options(False)
ADAPTIVE = AdaptiveReductionOption(10, 50, 1)
FIELDS = ("score", "q_begin", "q_end", "t_begin", "t_end", "align_len",
          "matches", "gaps", "gap_regions")
PENALTIES = {"4-6-2": Penalties(4, 6, 2), "2-0-2": Penalties(2, 0, 2),
             "3-5-2": Penalties(3, 5, 2), "6-2-3": Penalties(6, 2, 3),
             "4-6-1": Penalties(4, 6, 1)}
# every score of 2/1/1 has a wavefront, so a window past diagonal 0 never
# meets the reference's (0, 0) KRange fallback of an empty source row
# (wfa_component.go:91), which at 4/6/2 sends such a pair up a tier
PHASE2_PENALTIES = {"4-6-2": (Penalties(4, 6, 2), 0.08),
                    "2-1-1": (Penalties(2, 1, 1), 0.2)}
S0, K2 = 40, 256


def _assert_oracle(pairs, results, penalties=Penalties(4, 6, 2)):
    oracle = OracleAligner(penalties, SEMI, ADAPTIVE)
    assert len(results) == len(pairs)
    for (q, t), res in zip(pairs, results):
        ref = oracle.align(q, t)
        assert res.cigar(False) == ref.cigar(False), (q[:40], t[:40])
        for f in FIELDS:
            assert getattr(res, f) == getattr(ref, f), f


def _suffix_pair(err=0.08):
    """A 200-base read of the last 200 bases of a 400-base target, a share
    ``err`` of its bases substituted: its path runs near diagonal 200, so
    the narrow window starts past diagonal 0 (k02 > 0) and phase 2 reads a
    target row that holds only the target's suffix (toff2 < 0)."""
    rng = np.random.default_rng(3)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    t = acgt[rng.integers(0, 4, 400)]
    q = t[200:].copy()
    hit = rng.random(200) < err
    q[hit] = acgt[(rng.integers(1, 4, 200)[hit]
                   + np.searchsorted(acgt, q[hit])) % 4]
    return q.tobytes(), t.tobytes()


@functools.lru_cache(maxsize=None)
def _exports(p, suffix_err=0.08):
    """4 pairs of l=200, e=0.08 and :func:`_suffix_pair` through JAX's XLA
    prefix exporter and the port's plain one, at S0=40, K2=256 and the
    batch's full span."""
    jb = JaxBatchAligner(p, SEMI, ADAPTIVE, k_win=K2, s_cap=256,
                         engine=f"semi2:{S0}")
    pairs = generate_pairs(4, 200, 0.08, seed=7) + [_suffix_pair(suffix_err)]
    packed = jb._pack_all(pairs)
    qb, tbuf, qlen, tlen, toff, Lq, Ltb = packed[:7]
    Kf = ((int((qlen + tlen).max()) + 1 + 127) // 128) * 128
    cfg = dataclasses.replace(jb.cfg, k_win=Kf, w_win=None)
    jex = prefix_export_impl(*(jnp.asarray(a) for a in packed[:5]), cfg=cfg,
                             B=len(pairs), Lq=Lq, Ltb=Ltb, S0=S0, K2=K2)
    ins = te.inputs_from_packed(packed, "cpu")
    tex = ts.prefix_export_plain(*ins[:5], cfg=te.config_from_jax(cfg),
                                 Lq=Lq, Ltb=Ltb, S0=S0, K2=K2)
    return jb, pairs, packed, cfg, jex, tex


@pytest.mark.parametrize("pen_id", list(PENALTIES))
def test_prefix_export_plain_matches_xla(pen_id):
    """Every export of every pair, dtypes and shapes included: the window
    rows, ainit, the band slots, meta1 and aux_old (int16 at l=200)."""
    _, pairs, _, cfg, jex, tex = _exports(PENALTIES[pen_id])
    assert sorted(jex) == sorted(tex)
    for key in jex:
        a, b = np.asarray(jex[key]), tex[key].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a, b), key
    assert tex["aux_old"].dtype == torch.int16
    if pen_id != "2-0-2":  # 2/0/2 scores stay low: every pair ends by S0
        live = (tex["meta1"][:, ts.M1_DONE] == 0) & (
            tex["meta1"][:, ts.M1_OVF] == 0)
        assert int(live.sum()) >= 2, "test workload too easy"


def _canon_meta(m, live):
    """Phase-1 pairs done inside the prefix skip phase 2: their window
    placement is a don't-care, and the end columns count only when found
    (tests/test_semi2.py:160-172)."""
    m = m.copy()
    m[m[:, ts.M1_EFOUND] == 0, ts.M1_ES:ts.M1_ECELL + 1] = 0
    m[m[:, ts.M1_DONE] == 0, ts.M1_TERM] = 0
    m[~live, ts.M1_K02] = 0
    return m


def test_prefix_export_plain_matches_pallas_interpret():
    """The port's exports equal the TPU prefix kernel's (EXPORT mode,
    interpret) on live pairs, as tests/test_semi2.py holds the XLA
    exporter to it."""
    jb, pairs, packed, cfg, _, tex = _exports(PENALTIES["4-6-2"])
    qb, tbuf, qlen, tlen, toff, Lq, Ltb = packed[:7]
    kex = prefix_export_kernel_impl(*(jnp.asarray(a) for a in packed[:5]),
                                    cfg=cfg, B=len(pairs), Lq=Lq, Ltb=Ltb,
                                    S0=S0, K2=K2)
    mt = tex["meta1"].numpy()
    live = (mt[:, ts.M1_DONE] == 0) & (mt[:, ts.M1_OVF] == 0)
    assert live.sum() >= 2
    assert np.array_equal(_canon_meta(mt, live),
                          _canon_meta(np.asarray(kex["meta1"]), live))
    for key in ("b_m", "b_ie", "win_m", "win_i", "win_d", "ainit"):
        a = np.asarray(kex[key])[:, live]
        assert np.array_equal(a, tex[key].numpy()[:, live]), key


@pytest.mark.parametrize("pen_id", list(PHASE2_PENALTIES))
def test_phase2_plain_matches_jax(pen_id):
    """The port's phase 2 (plain resume, K2 over both aux tensors,
    compaction) gives "mtb" and "lg" byte streams equal to
    wfa_tpu.semi2.phase2 (Pallas resume in interpret mode) on the same
    exports and the same re-placed targets, one of them a suffix-only
    target row (toff2 < 0).  At 4/6/2 the suffix pair's first empty
    score sends it up a tier in both packages; at 2/1/1 it is served, and
    every served pair equals the oracle."""
    p, suffix_err = PHASE2_PENALTIES[pen_id]
    jb, pairs, packed, cfg, jex, tex = _exports(p, suffix_err)
    qb, tbuf, qlen, tlen, toff, Lq, Ltb, qp, tp = packed
    k02 = tex["meta1"][:, ts.M1_K02].numpy()
    t2raw, t2p, toff2, Ltb2 = ts.replace_targets([t for _, t in pairs], k02)
    assert t2p is not None and k02[-1] > 0  # a suffix-only target row
    seq2 = np.concatenate([qp, t2p], axis=1)
    lens2 = np.stack([qlen, tlen, toff2], axis=1).astype(np.int32)
    keys = ("win_m", "win_i", "win_d", "ainit", "b_m", "b_ie", "meta1",
            "aux_old")
    jout = jax_phase2(jnp.asarray(seq2), jnp.asarray(lens2),
                      *(jex[k] for k in keys), cfg=jb.cfg, B=len(pairs),
                      Lq=Lq, Ltb_full=Ltb, Ltb2=Ltb2, S0=S0, packed=True,
                      flat=True)
    tout = ts.phase2(torch.from_numpy(seq2), torch.from_numpy(lens2),
                     *(tex[k] for k in keys), cfg=te.config_from_jax(jb.cfg),
                     Lq=Lq, Ltb_full=Ltb, Ltb2=Ltb2, S0=S0, packed=True)
    assert sorted(tout) == ["final_s", "lg", "mtb"]
    for key in ("mtb", "lg"):
        a, b = np.asarray(jout[key]), tout[key].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a, b), key
    meta, toks = te.decode_outputs(pairs, tout["mtb"].numpy(),
                                   tout["lg"].numpy())
    ovf = meta[:, te.M_OVF] > 0
    assert list(ovf) == [False] * 4 + [pen_id == "4-6-2"]
    res = [te.DeviceResult.from_device(False, int(m[te.M_SCORE]), tk)
           for m, tk in zip(meta, toks)]
    for r, (q, t) in zip(res, pairs):  # as finish_tokens sets them
        r.lens = (len(q), len(t))
    _assert_oracle([pr for pr, o in zip(pairs, ovf) if not o],
                   [r for r, o in zip(res, ovf) if not o], p)


def test_resume_plain_int32_cells_match_int16():
    """Phase 2's aux cells are int32 when the phase-1 buffer is too long
    for int16 (Ltb_full + 2 > 4095): the same resume and backtrace give
    the same streams."""
    jb, pairs, packed, cfg, _, tex = _exports(PENALTIES["4-6-2"])
    qlen, tlen = packed[2], packed[3]
    Lq, Ltb = packed[5], packed[6]
    k02 = tex["meta1"][:, ts.M1_K02].numpy()
    _, t2p, toff2, Ltb2 = ts.replace_targets([t for _, t in pairs], k02)
    seq2 = torch.from_numpy(np.concatenate([packed[7], t2p], axis=1))
    lens2 = torch.from_numpy(
        np.stack([qlen, tlen, toff2], axis=1).astype(np.int32))
    keys = ("win_m", "win_i", "win_d", "ainit", "b_m", "b_ie", "meta1")
    outs = []
    for ltb_full, dtype in ((Ltb, torch.int16), (4094, torch.int32)):
        res = te.run_batch_resume_plain(
            *te.inputs_from_packed((packed[0], np.zeros((5, Ltb2), np.uint8),
                                    qlen, tlen, toff2, Lq, Ltb2), "cpu")[:1],
            te._unpack2(seq2[:, Lq // 4:], Ltb2, lens2[:, 2].clamp(min=0),
                        lens2[:, 2] + lens2[:, 1]),
            lens2[:, 0].contiguous(), lens2[:, 1].contiguous(),
            lens2[:, 2].contiguous(), *(tex[k] for k in keys),
            cfg=te.config_from_jax(jb.cfg), Lq=Lq, Ltb2=Ltb2,
            Ltb_full=ltb_full, S0=S0)
        assert res[4].dtype == dtype
        outs.append(res)
    for a, b in zip(outs[0][:4] + outs[0][5], outs[1][:4] + outs[1][5]):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][4].int(), outs[1][4])


@pytest.mark.parametrize("s0", [40, 16])
def test_batch_aligner_semi2_matches_jax(s0):
    """BatchAligner(engine="semi2:<S0>", device="cpu") serves the same
    pairs as JAX's (the same None pattern) with the same results; at
    S0=16 the prefix ends before the band collapses and pairs escape
    (None), never a wrong result."""
    p = Penalties(4, 6, 2)
    pairs = generate_pairs(8, 200, 0.05, seed=5)
    jax_res = JaxBatchAligner(p, SEMI, ADAPTIVE, k_win=256, s_cap=256,
                              engine=f"semi2:{s0}").align_batch(
                                  pairs, fallback=False)
    eng = te.BatchAligner(p, SEMI, ADAPTIVE, k_win=256, s_cap=256,
                          engine=f"semi2:{s0}", device="cpu")
    ours = eng.align_batch(pairs, fallback=False)
    assert [r is None for r in ours] == [r is None for r in jax_res]
    served = [(pr, r) for pr, r in zip(pairs, ours) if r is not None]
    for (_, r), j in zip(served, (j for j in jax_res if j is not None)):
        assert (r.score, r.cigar(False)) == (j.score, j.cigar(False))
    _assert_oracle([pr for pr, _ in served], [r for _, r in served])
    if s0 == 16:
        assert len(served) < len(pairs)
    else:
        assert len(served) >= 6
    assert eng.spans == {512}


def test_semi_ladder_matches_jax():
    """Route, S0, k_win and the exact full-span tier 3 equal
    wfa_tpu.pipeline's semi-global ladder; spans of 512 diagonals or
    fewer and runs without wf-adaptive keep the full span; the global
    ladder's tier 3 repeats tier 2."""
    from wfa_tpu.pipeline import AlignmentPipeline as JaxPipeline
    from wfa_tpu.pipeline import PipelineConfig as JaxConfig

    p = Penalties(4, 6, 2)
    for adaptive in (ADAPTIVE, None):
        ours = AlignmentPipeline(PipelineConfig(p, SEMI, adaptive,
                                                device="cpu"))
        ref = JaxPipeline(JaxConfig(p, SEMI, adaptive, n_devices=1))
        for length in (200, 320, 1000, 6000):
            full_span = -(-(2 * length + 1) // 128) * 128
            for tier in range(4):
                k, s, _, engine = ours._tier_caps(length, length, tier)[:4]
                jk, _, _, _, jengine = ref._tier_caps(length, length,
                                                      tier)[:5]
                assert k == jk, (length, tier)
                two_phase = (adaptive is not None and full_span > 512
                             and tier <= 2)
                assert engine.startswith("semi2:") == two_phase
                assert jengine.startswith("semi2:") == two_phase
                if two_phase:
                    assert engine == jengine, (length, tier)
                else:  # JAX may pick its XLA engine; K1-semi serves all
                    assert engine == "auto" and k == full_span
    glob = AlignmentPipeline(PipelineConfig(p, Options(True), ADAPTIVE,
                                            device="cpu"))
    for length in (1000, 50000):
        assert glob._tier_caps(length, length, 3) == glob._tier_caps(
            length, length, 2)


def test_pipeline_semi2_matches_oracle():
    """Semi-global pairs of l=320 run two-phase at tier 0 and equal the
    oracle."""
    pairs = generate_pairs(6, 320, 0.05, seed=9)
    pipe = AlignmentPipeline(PipelineConfig(Penalties(4, 6, 2), SEMI,
                                            ADAPTIVE, batch_size=6,
                                            device="cpu"))
    _assert_oracle(pairs, pipe.align_all(pairs))
    assert pipe.served[0] == len(pairs)
    assert {e for _, _, e in pipe._engines} == {"semi2:64"}


def test_pipeline_semi2_long_reads_match_oracle():
    """Semi-global reads of l=6000 (no longer refused over 4096 bases):
    phase 1 at a 12,032-diagonal span, phase 2 at 256, equal to the
    oracle."""
    pairs = generate_pairs(2, 6000, 0.01, seed=5)
    pipe = AlignmentPipeline(PipelineConfig(Penalties(4, 6, 2), SEMI,
                                            ADAPTIVE, device="cpu"))
    _assert_oracle(pairs, pipe.align_all(pairs))
    assert pipe.served[0] == len(pairs)
    (eng,) = pipe._engines.values()
    assert eng.engine == "semi2" and eng.cfg.k_win == 256
    assert eng.spans == {12032}
