"""Semi-global coordinates of the port's device results against the
oracle, on the CPU.

On rare semi-global pairs the oracle's CIGAR does not use up both
lengths: its leading ops stop a base off at row or column 1
(``wfa_tpu.backtrace``), while its coordinates are kept from the end
cell.  A walk of the merged ops forward from (0, 0) then lands one
diagonal off; ``DeviceResult`` walks them back from (len q, len t).
Here the two pairs on which the card fuzz found the drift
(``fuzz.DRIFT_PAIRS``) and a seeded sweep of semi-global pairs at random
penalties (``fuzz.draw_semi_groups``) go through K1-semi at the full
span, the two-phase route and a mesh of 2 CPU shards
(``BatchAligner(device="cpu")``, the kernels' plain versions), each held
to ``wfa_tpu``'s oracle on 11 fields; global results keep the forward
walk, which a global CIGAR makes equal to the backward one.  Every field
is an integer or a string: the tolerance is equality.
"""

import dataclasses
import functools
import random

import pytest
import torch

import wfa_tpu
from wfa_tpu_torch import AdaptiveReductionOption, Options, Penalties
from wfa_tpu_torch import parallel
from wfa_tpu_torch.engine import BatchAligner, windows
from wfa_tpu_torch.fuzz import (DRIFT_PAIRS, case_pair, draw_pairs,
                                draw_semi_groups, uses_lengths)

torch.set_num_threads(2)

FIELDS = ("score", "q_begin", "q_end", "t_begin", "t_end", "align_len",
          "matches", "gaps", "gap_regions")
# the sweep: groups of pairs of 30-200 bases, each at penalties of its own
SWEEP_SEED, SWEEP_GROUPS, SWEEP_SIZE = 0, 40, 4
ROUTES = ["k1semi", "semi2", "k1semi-mesh", "semi2-mesh"]


def _fields(res) -> tuple:
    """The 11 fields held: the CIGAR and its trimmed form, the score, the
    four coordinates and the four stats."""
    return (res.cigar(False), res.cigar(True)) + tuple(
        getattr(res, f) for f in FIELDS)


def _oracle(pen, ad, ga=False):
    return wfa_tpu.OracleAligner(
        wfa_tpu.Penalties(*dataclasses.astuple(pen)), wfa_tpu.Options(ga),
        ad and wfa_tpu.AdaptiveReductionOption(*dataclasses.astuple(ad)))


def _caps(pen, pairs) -> tuple:
    """(full span, a score cap above every pair's global end)."""
    longest = max(max(len(q), len(t)) for q, t in pairs)
    spread = max(abs(len(q) - len(t)) for q, t in pairs)
    s_cap = -(-(pen.mismatch * longest + pen.gap_open
                + pen.gap_ext * (spread + 1) + 8) // 8) * 8
    return -(-(2 * longest + 2) // 128) * 128, s_cap


def _align(route: str, pen, ad, pairs) -> list:
    """``pairs`` through K1-semi at the full span ("k1semi") or the
    two-phase route ("semi2", S0 16 or the penalties' least), on the CPU
    or on a mesh of 2 CPU shards ("-mesh"); None where a pair is not
    served."""
    span, s_cap = _caps(pen, pairs)
    S0 = max(windows(pen)[0], 16)
    engine, k_win = (("auto", span) if route.startswith("k1semi")
                     else (f"semi2:{S0}", min(256, span)))
    mesh = (parallel.make_dp_mesh(2, device="cpu")
            if route.endswith("mesh") else None)
    eng = BatchAligner(pen, Options(False), ad, k_win=k_win,
                       s_cap=max(s_cap, S0 + 8), device="cpu",
                       engine=engine, mesh=mesh)
    return eng.align_batch(pairs, fallback=False)


def _assert_oracle(route, pen, ad, pairs, results) -> int:
    """Every served result equals the oracle's 11 fields; K1-semi at the
    full span serves every pair.  Returns the count served."""
    oracle = _oracle(pen, ad)
    served = 0
    for (q, t), r in zip(pairs, results):
        if r is None:
            assert not route.startswith("k1semi"), (pen, ad, q, t)
            continue
        served += 1
        assert _fields(r) == _fields(oracle.align(q, t)), (route, pen, q, t)
    return served


@pytest.mark.parametrize("route", ROUTES)
def test_fuzz_drift_pairs(route):
    """The card fuzz's two drift pairs (seed 1 case 20: Penalties(7, 3, 2),
    10/20/1; seed 7 case 7 pair 8: Penalties(5, 1, 1)) with their own
    cases' penalties, where the oracle's CIGAR misses a length, equal the
    oracle through each route."""
    for seed, case, index in DRIFT_PAIRS:
        drawn, (q, t) = case_pair(seed, case, index)
        pen = Penalties(*drawn["penalties"])
        ad = AdaptiveReductionOption(*drawn["adaptive"])
        assert not uses_lengths(_oracle(pen, ad).align(q, t), q, t)
        res = _align(route, pen, ad, [(q, t)])
        assert _assert_oracle(route, pen, ad, [(q, t)], res) == 1


@functools.lru_cache(maxsize=None)
def _sweep_drift_groups() -> tuple:
    """The sweep's groups that hold a pair whose oracle CIGAR misses a
    length, and the count of such pairs."""
    groups, n = [], 0
    for pen, ad, pairs in draw_semi_groups(random.Random(SWEEP_SEED),
                                           SWEEP_GROUPS, SWEEP_SIZE):
        oracle = _oracle(pen, ad)
        drift = sum(not uses_lengths(oracle.align(q, t), q, t)
                    for q, t in pairs)
        if drift:
            groups.append((pen, ad, pairs))
            n += drift
    return groups, n


@pytest.mark.parametrize("route", ROUTES)
def test_semi_sweep_matches_oracle(route):
    """A seeded sweep of semi-global pairs at random penalties: each group
    that holds a drift pair (at least one does) equals the oracle on all
    11 fields through each route, the drift pairs served."""
    groups, n_drift = _sweep_drift_groups()
    assert n_drift >= 1
    for pen, ad, pairs in groups:
        res = _align(route, pen, ad, pairs)
        _assert_oracle(route, pen, ad, pairs, res)
        oracle = _oracle(pen, ad)
        for (q, t), r in zip(pairs, res):
            if not uses_lengths(oracle.align(q, t), q, t):
                assert r is not None, (route, pen, q, t)


def test_global_walks_agree():
    """Global device results: the forward walk of the ops from (0, 0)
    that they keep and a backward walk from (len q, len t) give the same
    coordinates, the oracle's."""
    rng = random.Random(5)
    n = 0
    for _ in range(6):
        pen = Penalties(rng.randint(1, 8), rng.randint(0, 8),
                        rng.randint(1, 4))
        pairs = draw_pairs(rng, 6, rng.randint(60, 200),
                           rng.choice((0.02, 0.1, 0.2)), False)
        span, s_cap = _caps(pen, pairs)
        eng = BatchAligner(pen, Options(True), None, k_win=span,
                           s_cap=s_cap, device="cpu")
        oracle = _oracle(pen, None, ga=True)
        for (q, t), r in zip(pairs, eng.align_batch(pairs, fallback=False)):
            want = _fields(oracle.align(q, t))
            assert _fields(r) == want
            assert uses_lengths(r, q, t)
            # the same ops walked back from the end
            r.global_alignment, r.lens = False, (len(q), len(t))
            r._derive_from_ops()
            assert _fields(r) == want
            n += 1
    assert n == 36
