"""The benchmark's arithmetic: the rate and the tail of a call log, the
spreads, the traffic generator, and the roofline's byte count."""

import numpy as np
import pytest
import torch

from portbench import roofline, stats, trace, traffic

MIX = {"length": 1000, "error_rate": 0.05, "pairs_per_call": 64,
       "pool_calls": 3, "warmup_calls": 3, "trace_calls": 2,
       "check_per_call": 8, "check_retried_per_call": 2}


def test_rate_and_nearest_rank_on_a_call_log():
    calls = [0.05] * 90 + [0.2] * 9 + [1.0]  # 100 calls, 7.3 s
    assert stats.rate(4096 * len(calls), sum(calls)) == pytest.approx(
        409600 / 7.3)
    assert stats.nearest_rank(calls, 95) == 0.2  # rank 95 of 100
    assert stats.nearest_rank(calls, 90) == 0.05
    assert stats.nearest_rank([3.0], 95) == 3.0
    assert stats.nearest_rank(list(range(1, 21)), 95) == 19


def test_spreads():
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 30.0]
    # 30 lies farthest from the median 12.5: range 10..14 over 12.5
    assert stats.trimmed_range_share(vals) == pytest.approx(4 / 12.5)
    q1, _, q3 = __import__("statistics").quantiles(vals, n=4)
    assert stats.iqr_share(vals) == pytest.approx((q3 - q1) / 12.5)


def test_traffic_is_the_seeds_and_has_its_edits():
    a = traffic.make_pool(MIX, 2**31 + 5)
    b = traffic.make_pool(MIX, 2**31 + 5)
    c = traffic.make_pool(MIX, -7)
    assert a == b and a != c
    pairs = [p for call in a for p in call]
    assert len(pairs) == 192 and len(set(pairs)) == 192
    for q, t in pairs:
        assert len(q) == 1000 and set(q) <= set(b"ACGT")
        assert set(t) <= set(b"ACGT") and abs(len(t) - 1000) <= 50
    # ~50 edits a pair: the targets differ from their queries
    diff = np.mean([sum(x != y for x, y in zip(q, t)) for q, t in pairs])
    assert diff > 100


def test_sample_spreads_over_the_cards():
    s = traffic.sample(MIX, 11, 4)
    assert len(s) == 3
    for idx in s:
        # each card's first and last row, and 8 more drawn, 2 a card
        assert len(idx) == 16 and idx == sorted(set(idx))
        assert [sum(16 * q <= i < 16 * (q + 1) for i in idx)
                for q in range(4)] == [4, 4, 4, 4]
        assert {0, 15, 16, 31, 32, 47, 48, 63} <= set(idx)
    assert traffic.sample(MIX, 11, 4) == s
    assert s != traffic.sample(MIX, 12, 4)
    one = traffic.sample(dict(MIX, pairs_per_call=3), 11, 1)
    assert one == [[0, 1, 2]] * 3  # a call smaller than the sample: all


def test_roofline_bytes_by_hand():
    # K1 over 2 pairs of 8-byte rows (k_win 4, int32 cells): pair 0 served
    # at score 2 (3 rows), pair 1 overflowed
    got = roofline.score_loop(in_bytes=2 * 8 + 2 * 16 + 2 * 12, B=2, K=4,
                              cell=4, base=0, final_s=[2, 9],
                              served=[True, False])
    cells = 3 * 3 * 4
    assert got == (72 + 28 * 2 + cells * 4, cells)
    # K1-long's int16 cells carry a 4-byte base word a row
    assert roofline.score_loop(0, 1, 4, 2, 4, [1], [True]) == (
        28 + 24 * 2 + 2 * 4, 24)
    # K3: a pair done at score 3 of S0 8 writes 4 rows, a live one 8
    assert roofline.prefix(100, 50, Kf=16, cell=2, S0=8, final_s=[3, 20],
                           done=[True, False]) == (
        150 + 3 * 12 * 16 * 2, 3 * 12 * 16)
    # K4 writes rows S0..final_s of the pairs served past S0
    assert roofline.resume(10, 2, 4, 2, 8, [10, 5], [True, True]) == (
        10 + 56 + 3 * 3 * 4 * 2, 36)
    assert roofline.backtrace(B=2, token_bytes=40, step=4, steps=7) == (
        50 + 28 + 40 + 8, 7)
    assert roofline.least_seconds(3_350_000, 0) == pytest.approx(1e-6)


def test_the_wrappers_count_what_the_kernels_got():
    """The traced run's records of a score-loop launch and a backtrace,
    from the tensors the wrappers see, give the hand count above."""
    B, L, K, S = 2, 8, 4, 10
    args = (torch.zeros(B, L, dtype=torch.uint8),
            torch.zeros(B, 2 * L, dtype=torch.uint8),
            *(torch.zeros(B, dtype=torch.int32) for _ in range(3)))
    out = (torch.tensor([2, 9], dtype=torch.int32),
           torch.tensor([True, True]), torch.tensor([False, True]),
           None, torch.zeros(3, S, B, K, dtype=torch.int32),
           (None, None, None))
    inst = trace.Instrument()
    inst.launches.append(trace._score_record(args, {}, out))
    bt = (torch.zeros(B, dtype=torch.int16),
          torch.zeros(3, B, 2, dtype=torch.int16),
          torch.zeros(B, 4, dtype=torch.int16),
          torch.tensor([3, 4], dtype=torch.int32))
    inst.launches.append(trace._backtrace_record(
        (torch.zeros(3, S, B, K, dtype=torch.int32),), {}, bt))
    least, n = inst.roofline()
    k1 = 72 + 56 + 36 * 4
    k2 = 50 + (2 + 12 + 8) * 2 + 8 + 7 * 4
    assert n == 2
    assert least == pytest.approx((k1 + k2) / roofline.HBM_BYTES_PER_S)
