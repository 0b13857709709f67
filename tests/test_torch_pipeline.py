"""The port's entry point vs the exact oracle, on the CPU.

``wfa_tpu_torch.pipeline.AlignmentPipeline(device="cpu").align_all``
must equal ``wfa_tpu.oracle`` on score, CIGAR, q/t begin/end, align_len,
matches, gaps and gap_regions, whichever tier served the pair."""

import random

import pytest
import torch

from wfa_tpu import (AdaptiveReductionOption, EmptySeqError, Options,
                     OracleAligner, Penalties)
from wfa_tpu.datagen import generate_pairs
from wfa_tpu.io import read_pairs
from wfa_tpu_torch.engine import BatchAligner
from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

from test_pallas_engine import random_pairs

torch.set_num_threads(2)

ADAPTIVE = AdaptiveReductionOption(10, 50, 1)
FIELDS = ("score", "q_begin", "q_end", "t_begin", "t_end", "align_len",
          "matches", "gaps", "gap_regions")
GOLDEN = [  # (query, target, score, cigar) with 4/6/2 and 10/50/1
    (b"AGCTAGTGTCAATGGCTACTTTTCAGGTCCT",
     b"AACTAAGTGTCGGTGGCTACTATATATCAGGTCCT", 36, "1M1X3M1I5M2X8M3I1M1X9M"),
]


def _assert_oracle(pairs, results, penalties, adaptive):
    oracle = OracleAligner(penalties, Options(True), adaptive)
    assert len(results) == len(pairs)
    for (q, t), res in zip(pairs, results):
        ref = oracle.align(q, t)
        assert res.cigar(False) == ref.cigar(False), (q, t)
        for f in FIELDS:
            assert getattr(res, f) == getattr(ref, f), (f, q, t)


@pytest.mark.parametrize("penalties,adaptive", [
    (Penalties(4, 6, 2), ADAPTIVE),
    (Penalties(4, 6, 2), None),
    (Penalties(2, 3, 1), ADAPTIVE),
], ids=["adaptive", "plain", "degenerate"])
def test_pipeline_matches_oracle(penalties, adaptive):
    pairs = random_pairs(random.Random(17), 24, 80)
    pairs += list(read_pairs("tests/data/seqs.txt"))[:3]
    pairs += [(q, t) for q, t, _, _ in GOLDEN]
    pipe = AlignmentPipeline(PipelineConfig(penalties, Options(True),
                                            adaptive, batch_size=16))
    _assert_oracle(pairs, pipe.align_all(pairs), penalties, adaptive)
    # a second call runs at the score caps the first one learned
    _assert_oracle(pairs, pipe.align_all(pairs), penalties, adaptive)


def test_pipeline_golden_values():
    pipe = AlignmentPipeline(PipelineConfig(Penalties(4, 6, 2), Options(True),
                                            ADAPTIVE))
    seqs = list(read_pairs("tests/data/seqs.txt"))[0]
    res = pipe.align_all([(q, t) for q, t, _, _ in GOLDEN] + [seqs])
    for r, (_, _, score, cigar) in zip(res, GOLDEN):
        assert (r.score, r.cigar(False)) == (score, cigar)
    assert (res[-1].score, res[-1].cigar(False)) == (
        36, "1X1I14M1D39M1D31M1D12M")
    assert (res[-1].q_begin, res[-1].q_end, res[-1].t_begin,
            res[-1].t_end) == (2, 100, 3, 98)


def test_pipeline_tier_retry_and_oracle_tier():
    """A band that leaves the tier-0 window retries at tier 1; a memory
    budget that caps every tier's score below the pairs' scores sends
    them to the final oracle tier."""
    p = Penalties(4, 6, 2)
    q = generate_pairs(1, 300, 0.0, seed=3)[0][0]
    pairs = [(q, q[:150]), (q[:140], q)] + generate_pairs(6, 120, 0.05, seed=4)
    pipe = AlignmentPipeline(PipelineConfig(p, Options(True), ADAPTIVE,
                                            batch_size=4))
    _assert_oracle(pairs, pipe.align_all(pairs), p, ADAPTIVE)
    assert pipe.served[1] >= 2 and pipe.served["oracle"] == 0

    noisy = generate_pairs(5, 200, 0.3, seed=5)
    small = AlignmentPipeline(PipelineConfig(
        p, Options(True), ADAPTIVE, batch_size=4, mem_budget=12 * 128 * 64))
    _assert_oracle(noisy, small.align_all(noisy), p, ADAPTIVE)
    assert small.served["oracle"] == len(noisy)


def test_guards_and_unported_modes():
    p = Penalties(4, 6, 2)
    pipe = AlignmentPipeline(PipelineConfig(p, Options(True), ADAPTIVE))
    res = pipe.align_all([(b"", b"ACGT"), (b"ACGT", b"ACGA")])
    assert isinstance(res[0].error, EmptySeqError)
    assert res[1].error is None and res[1].score == 4
    with pytest.raises(EmptySeqError):
        BatchAligner(p, Options(True), ADAPTIVE).align_batch([(b"A", b"")])
    with pytest.raises(ValueError):
        BatchAligner(p, Options(True), AdaptiveReductionOption(0, 50, 1))
    with pytest.raises(NotImplementedError):
        AlignmentPipeline(PipelineConfig(p, Options(False), ADAPTIVE))
    with pytest.raises(NotImplementedError):
        BatchAligner(p, Options(False), ADAPTIVE)
    with pytest.raises(NotImplementedError):
        pipe.align_all([(b"A" * 4097, b"A" * 4097)])
