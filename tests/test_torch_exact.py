"""Exact global alignment (wf-adaptive reduction off, the CLI's ``-a``)
through the port's main path on the CPU, against the benchmark's plain
reference (:mod:`portbench.reference`), answer for answer: score, CIGAR
runs, four coordinates and four stats.

``AlignmentPipeline(PipelineConfig(adaptive=None, device="cpu"))`` runs
K1 without its reduce at the full-span window and K2 over its int32 aux
in their plain versions; the tier ladder raises only the score cap.  The
pairs are the benchmark's own (``portbench.traffic``) at 20% error, as
the cell ``exact.l1000-e20`` draws them; a constructed pair shows that
the heuristic is really off; and the call's counters of retried pairs
and aux rows add up."""

import numpy as np
import pytest
import torch

from portbench import check, traffic
from portbench.reference import Aligner, answer
from wfa_tpu_torch import AdaptiveReductionOption, Options, Penalties, trace
from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

torch.set_num_threads(2)

EXACT = Aligner((4, 6, 2), True, None)


def _pipe(adaptive=None, **kw):
    return AlignmentPipeline(PipelineConfig(
        Penalties(4, 6, 2), Options(True), adaptive, device="cpu", **kw))


def _pairs(n, length, error_rate, seed):
    return traffic.make_pairs(traffic.rng(seed, 0), n, length, error_rate)


def _assert_reference(pairs, results, aligner=EXACT):
    assert len(results) == len(pairs)
    for (q, t), res in zip(pairs, results):
        assert check.program_answer(res) == answer(
            aligner.align(q, t)), (q, t)


def _assert_counters_add_up(pipe, n):
    rec = trace.records(1)[0]
    assert rec["pairs"] == n
    served = sum(v for k, v in pipe.served.items() if k != "oracle")
    assert pipe.served["oracle"] == 0
    # every pair a tier above 0 served was retried, each counted once
    assert served - pipe.served[0] <= rec["retried_pairs"] <= n
    assert 0 < rec["aux_rows_used"] <= rec["aux_rows"]
    return rec


@pytest.mark.parametrize("length,n", [(240, 24), (1000, 6)],
                         ids=["l240", "l1000"])
def test_exact_pipeline_matches_the_reference(length, n):
    """The cell's traffic at 20% error.  At l=1000 the cold tier 0's score
    cap (640) lies below every pair's score (~900), so the ladder's tier
    1 (1920) serves them all."""
    pairs = _pairs(n, length, 0.20, 2**31 + 29)
    pipe = _pipe()
    results = pipe.align_all(pairs)
    _assert_reference(pairs, results)
    rec = _assert_counters_add_up(pipe, n)
    if length == 1000:
        assert pipe.served[1] == n and rec["retried_pairs"] == n
        # the aux of both tiers: 640 and 1920 rows a pair
        assert rec["aux_rows"] == (640 + 1920) * n
        assert rec["aux_rows_used"] == sum(r.score + 1 for r in results)


def test_a_small_score_cap_retries_on_tier_1():
    """A small ``s_cap_base`` lets the score memory of an easy call (5%
    error) fit tier 0's cap below the scores of the next call (20%), whose
    pairs then retry on tier 1 and must still equal the reference."""
    pipe = _pipe(s_cap_base=64)
    easy = _pairs(8, 240, 0.05, 2**31 + 31)
    _assert_reference(easy, pipe.align_all(easy))
    hard = _pairs(16, 240, 0.20, 2**31 + 37)
    results = pipe.align_all(hard)
    _assert_reference(hard, results)
    assert pipe.served[1] > 0
    rec = _assert_counters_add_up(pipe, len(hard))
    assert rec["retried_pairs"] >= pipe.served[1]


def test_the_heuristic_is_off():
    """A target that carries a 100-base copy of a later stretch of its
    query in front: the exact path inserts it (score 210), while
    wf-adaptive reduction drops that diagonal early and lands on 376.  The
    port in exact mode gives the exact answer; with the reduction on it
    gives the reduced reference's."""
    q = traffic.BASES[np.random.default_rng(5).integers(0, 4, 240)].tobytes()
    t = q[40:140] + q
    reduced = Aligner((4, 6, 2), True, (10, 50))
    assert EXACT.align(q, t).score == 210
    assert reduced.align(q, t).score == 376
    pairs = [(q, t)] + _pairs(3, 240, 0.20, 2**31 + 41)
    _assert_reference(pairs, _pipe().align_all(pairs))
    pipe = _pipe(AdaptiveReductionOption(10, 50, 1))
    _assert_reference(pairs, pipe.align_all(pairs), reduced)
