"""The global score loops at the penalties' stride, on the CPU.

Every score a wavefront can hold is a sum of the penalties, so at
penalties whose greatest common divisor g passes 1 only the rows of
scores 0, g, 2g, ... can hold a cell.  ``engine.align_full2`` runs K1,
K1-long and K1-kw, and K2 over their aux, at the penalties divided by g
(``engine.loop_config``).  These tests hold its output streams to the
JAX package's ``_align_full2``, which runs every score, byte for byte,
and to the port's own stride-1 path; decode them against the oracle;
check the score cap's edge, where a pair's score is the last the loop
tests or just past it; and check that semi-global loops keep stride 1 and
that every benchmark cell runs at stride 2."""

import dataclasses
import functools
import random
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wfa_tpu
from portbench import manifest
from wfa_tpu.engine import BatchAligner as JaxBatchAligner
from wfa_tpu.engine import _align_full2
from wfa_tpu_torch import AdaptiveReductionOption, Options, Penalties
from wfa_tpu_torch import engine as te
from wfa_tpu_torch import kernel_engine
from wfa_tpu_torch.oracle import Aligner as OracleAligner

from test_pallas_engine import random_pairs

torch.set_num_threads(2)

ADAPTIVE = AdaptiveReductionOption(10, 50, 1)
# g = 1, 2, 3 and 4
PENALTIES = {"4-6-1": (4, 6, 1), "4-6-2": (4, 6, 2), "6-9-3": (6, 9, 3),
             "8-12-4": (8, 12, 4)}
FIELDS = ("score", "q_begin", "q_end", "t_begin", "t_end", "align_len",
          "matches", "gaps", "gap_regions")


def _streams(pairs, pen, adaptive, s_cap, k_win=128):
    """(jax cfg, seq, lens, Lq, Ltb) of ``pairs`` packed as the JAX
    aligner packs them."""
    jb = JaxBatchAligner(
        wfa_tpu.Penalties(*pen), wfa_tpu.Options(True),
        adaptive and wfa_tpu.AdaptiveReductionOption(
            adaptive.min_wf_len, adaptive.max_dist_diff, 1),
        k_win=k_win, s_cap=s_cap, engine="jax")
    qb, tbuf, qlen, tlen, toff, Lq, Ltb, qp, tp = jb._pack_all(pairs)
    seq = np.concatenate([qp, tp], axis=1)
    lens = np.stack([qlen, tlen, toff], axis=1).astype(np.int32)
    return jb.cfg, seq, lens, Lq, Ltb


@functools.lru_cache(maxsize=None)
def _jax_case(pen_id, adaptive_on, s_cap=None, batch="random"):
    """JAX's ``_align_full2`` streams of a batch: the case's pairs, its
    inputs and its "mtb" and "lg" bytes."""
    pen = PENALTIES[pen_id]
    pairs = _PAIRS[batch](pen)
    adaptive = ADAPTIVE if adaptive_on else None
    s_cap = s_cap or 96 * te.score_stride(
        te.EngineConfig(penalties=Penalties(*pen), s_cap=1 << 20))
    cfg, seq, lens, Lq, Ltb = _streams(pairs, pen, adaptive, s_cap)
    jout = _align_full2(jnp.asarray(seq), jnp.asarray(lens), cfg=cfg,
                        B=len(pairs), Lq=Lq, Ltb=Ltb, engine="jax",
                        packed=True, flat=True)
    return (pairs, te.config_from_jax(cfg), seq, lens, Lq, Ltb,
            {k: np.asarray(jout[k]) for k in ("mtb", "lg")})


def _random_pairs(pen):
    pairs = random_pairs(random.Random(sum(pen)), 14, 80)
    return [(q.replace(b"N", b"A"), t.replace(b"N", b"A")) for q, t in pairs]


def _mismatch_pairs(pen):
    """Pairs of 60 bases whose targets differ by m = 0..6 substitutions, 8
    bases apart: each pair's score is m x mismatch."""
    rng = random.Random(7)
    q = bytes(rng.choice(b"ACGT") for _ in range(60))
    pairs = []
    for m in range(7):
        t = bytearray(q)
        for i in range(m):
            t[4 + 8 * i] = b"ACGT"[(b"ACGT".index(t[4 + 8 * i]) + 1) % 4]
        pairs.append((q, bytes(t)))
    return pairs


_PAIRS = {"random": _random_pairs, "mismatch": _mismatch_pairs}


def _port(case, engine, stride_one=False):
    """The port's streams of a case on ``engine`` (K1-kw at KW 128), at
    the penalties' stride or, with ``stride_one``, at every score."""
    pairs, cfg, seq, lens, Lq, Ltb, _ = case
    if engine == "kw":
        cfg = dataclasses.replace(cfg, aux_kw=128)
    with pytest.MonkeyPatch.context() as mp:
        if stride_one:
            mp.setattr(te, "score_stride", lambda c: 1)
        out = te.align_full2(torch.from_numpy(seq), torch.from_numpy(lens),
                             cfg=cfg, B=len(pairs), Lq=Lq, Ltb=Ltb,
                             packed=True, engine=engine)
    return {k: v.numpy() for k, v in out.items()}


def _assert_bytes(want, got):
    assert sorted(got) == ["lg", "mtb"]
    for key in ("mtb", "lg"):
        a, b = want[key], got[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a, b), key


@pytest.mark.parametrize("engine", ["auto", "long", "kw"])
@pytest.mark.parametrize("adaptive_on", [True, False],
                         ids=["adaptive", "exact"])
@pytest.mark.parametrize("pen_id", list(PENALTIES))
def test_align_full2_matches_jax_at_every_stride(pen_id, adaptive_on,
                                                 engine):
    """K1, K1-long and K1-kw at the stride of penalties with g = 1..4:
    the streams equal JAX's (every score run) and the port's at stride 1,
    and the served pairs decode to the oracle's results."""
    case = _jax_case(pen_id, adaptive_on)
    pairs, cfg = case[0], case[1]
    g = te.score_stride(cfg)
    assert g == {"4-6-1": 1, "4-6-2": 2, "6-9-3": 3, "8-12-4": 4}[pen_id]
    got = _port(case, engine)
    _assert_bytes(case[-1], got)
    if g > 1:
        _assert_bytes(_port(case, engine, True), got)
    meta, toks = te.decode_outputs(pairs, got["mtb"], got["lg"])
    assert (meta[:, te.M_OVF] == 0).sum() >= len(pairs) // 2
    oracle = OracleAligner(Penalties(*PENALTIES[pen_id]), Options(True),
                           ADAPTIVE if adaptive_on else None)
    for (q, t), m, tk in zip(pairs, meta, toks):
        if m[te.M_OVF]:
            continue
        res = te.DeviceResult.from_device(True, int(m[te.M_SCORE]),
                                          (tk, q, t))
        ref = oracle.align(q, t)
        assert res.cigar(False) == ref.cigar(False)
        for f in FIELDS:
            assert getattr(res, f) == getattr(ref, f), f


@pytest.mark.parametrize("engine", ["auto", "long", "kw"])
@pytest.mark.parametrize("pen_id,s_caps", [
    ("4-6-2", (16, 17, 18, 19)), ("8-12-4", (32, 33, 34, 35, 36, 40))])
def test_the_score_caps_edge(pen_id, s_caps, engine):
    """Pairs whose scores are 0, x, 2x, ... 6x against caps around them:
    a pair is served where its score is at most s_cap - 2, the last score
    the loop tests, and overflows above it; the loop's rows at the stride
    keep that edge, so flags and scores equal JAX's and the stride-1
    path's at every cap."""
    x = PENALTIES[pen_id][0]
    for s_cap in s_caps:
        case = _jax_case(pen_id, True, s_cap, "mismatch")
        got = _port(case, engine)
        _assert_bytes(case[-1], got)
        _assert_bytes(_port(case, engine, True), got)
        meta, _ = te.decode_outputs(case[0], got["mtb"], got["lg"])
        scores = x * np.arange(len(case[0]))
        served = scores <= s_cap - 2
        assert np.array_equal(meta[:, te.M_OVF] == 0, served), s_cap
        assert np.array_equal(meta[served, te.M_SCORE], scores[served])
        assert served.any() and not served.all()


@pytest.mark.parametrize("ga", [True, False], ids=["global", "semi"])
def test_the_launch_config(ga, monkeypatch):
    """A global loop at 4/6/2 launches at 2/3/1 with (s_cap - 2) // 2 + 2
    rows; a semi-global one at the configured penalties and cap."""
    pairs = _random_pairs((4, 6, 2))[:6]
    seen = []
    run_batch = kernel_engine.run_batch

    def spy(*a, **kw):
        seen.append(kw["cfg"])
        return run_batch(*a, **kw)

    monkeypatch.setattr(kernel_engine, "run_batch", spy)
    aligner = te.BatchAligner(Penalties(4, 6, 2), Options(ga), ADAPTIVE,
                              k_win=128 if ga else 256, s_cap=200,
                              device="cpu")
    res = aligner.align_batch(pairs)
    assert all(r is not None for r in res)
    assert len(seen) == 1
    cfg = seen[0]
    if ga:
        assert cfg.penalties == Penalties(2, 3, 1) and cfg.s_cap == 101
    else:
        assert cfg == aligner.cfg
        assert te.score_stride(aligner.cfg) == 1


def test_stride_rules():
    """g is the penalties' greatest common divisor on a global loop whose
    mismatch seed row fits its cap, else 1; the loop's rows keep the last
    tested score's multiples of g."""
    def cfg(pen, s_cap=640, ga=True, **kw):
        return te.EngineConfig(penalties=Penalties(*pen), s_cap=s_cap,
                               global_alignment=ga, **kw)

    assert te.score_stride(cfg((4, 6, 2))) == 2
    assert te.score_stride(cfg((6, 9, 3))) == 3
    assert te.score_stride(cfg((2, 0, 2))) == 2
    assert te.score_stride(cfg((4, 5, 2))) == 1
    assert te.score_stride(cfg((4, 6, 1))) == 1
    assert te.score_stride(cfg((4, 6, 2), ga=False)) == 1
    assert te.score_stride(cfg((4, 6, 2), prefix=True)) == 1
    assert te.score_stride(cfg((4, 6, 2), s_cap=4)) == 1
    assert te.score_stride(cfg((4, 6, 2), s_cap=5)) == 2
    c = cfg((4, 6, 1))
    assert te.loop_config(c, 1) is c
    for s_cap in range(5, 80):
        for g, pen in ((2, (4, 6, 2)), (3, (6, 9, 3)), (4, (8, 12, 4))):
            lc = te.loop_config(cfg(pen, s_cap), g)
            assert lc.penalties == Penalties(*(p // g for p in pen))
            last = g * (lc.s_cap - 2)  # the last score the loop tests
            assert last <= s_cap - 2 < last + g


_ROOT = Path(__file__).resolve().parent.parent
_CELLS = [w["name"] for w in manifest.load(_ROOT)["workloads"]]


@pytest.mark.parametrize("name", _CELLS)
def test_every_cell_runs_its_loops_at_stride_2(name):
    """Each benchmark cell's configuration is global alignment at 4/6/2,
    so its score loops launch at 2/3/1 over half the rows: the stride
    follows from the penalties, with nothing for a run to count."""
    from portbench import run

    cell = manifest.cell(manifest.load(_ROOT), name, _ROOT)
    pcfg = run.pipeline_config(cell.config, "cpu")
    cfg = te.EngineConfig(penalties=pcfg.penalties, adaptive=pcfg.adaptive,
                          global_alignment=pcfg.options.global_alignment,
                          s_cap=640)
    assert te.score_stride(cfg) == 2
    lcfg = te.loop_config(cfg, 2)
    assert lcfg.penalties == Penalties(2, 3, 1) and lcfg.s_cap == 321
