"""The frozen reference against pairs worked by hand and the reference
aligner's recorded outputs, and the control that must not pass for it."""

import pytest

from portbench import check, traffic
from portbench.reference import Aligner, answer

G = Aligner((4, 6, 2), True, (10, 50))
S = Aligner((4, 6, 2), False, (10, 50))


def test_global_pair_by_hand():
    # ACGT against AGT: the C deleted (D consumes the query) costs the gap
    # open and one extension, 6 + 2; two mismatches and a gap cost more
    assert answer(G.align(b"ACGT", b"AGT")) == (
        8, (("M", 1), ("D", 1), ("M", 2)), 1, 4, 1, 3, 4, 3, 1, 1)


def test_semi_global_pair_by_hand():
    # a read wholly inside its context costs nothing: the flanks of the
    # target are free insertions (I consumes the target) outside the
    # matched region, which starts at the target's third base
    assert answer(S.align(b"GATTACA", b"TTGATTACATT")) == (
        0, (("I", 2), ("M", 7), ("I", 2)), 1, 7, 3, 9, 7, 7, 0, 0)


def _cigar(res):
    return "".join(f"{n}{op}" for op, n in res.ops)


def test_recorded_outputs_of_the_reference_aligner():
    # its README.md:115-124 (global) and :230-254 (semi-global)
    res = G.align(b"ACCATACTCG", b"AGGATGCTCG")
    assert (res.score, _cigar(res)) == (12, "1M2X2M1X4M")
    assert (res.q_begin, res.q_end, res.t_begin, res.t_end) == (1, 10, 1, 10)
    res = S.align(b"Bioinformatics helps Biology",
                  b"We learn bioinformatics to help biologists")
    assert (res.score, _cigar(res)) == (32, "9I1X14M3I4M1D1M1X5M1X3I")


@pytest.mark.parametrize("global_alignment,n", [(True, 24), (False, 4)])
def test_the_control_fails_where_the_reference_passes(global_alignment, n):
    """The control (a gap wins its ties with a mismatch) keeps every score
    and changes CIGARs: at the cells' reads it is caught on a sample a test
    run can hold."""
    mix = {"length": 1000, "error_rate": 0.05, "pairs_per_call": n,
           "pool_calls": 1}
    pairs = traffic.make_pool(mix, 2**31 + 3)[0]
    config = {"penalties": {"mismatch": 4, "gap_open": 6, "gap_ext": 2},
              "global_alignment": global_alignment,
              "adaptive": {"min_wf_len": 10, "max_dist_diff": 50}}
    args = check.aligner_args(config)
    ref = check.reference_answers(pairs, args, workers=1)
    ctl = check.reference_answers(pairs, args[:-1] + (True,), workers=1)
    assert [a[0] for a in ref] == [a[0] for a in ctl]
    assert sum(a != b for a, b in zip(ref, ctl)) >= 1
