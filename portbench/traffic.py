"""The one generator every traffic mix goes through.

A mix is a JSON file of parameters (``portbench/traffic/<name>.json``):
read length, error rate, pairs a call, the pool of distinct calls the
window cycles through, warm-up calls, the calls a traced run profiles,
and the results a run checks.  Pairs follow the reference's dataset
tool (its README.md:300-306; the WFA ``generate_dataset``): a random
query over ACGT, and a target made from it by ``round(length *
error_rate)`` point edits, each a substitution, a deletion or an
insertion with equal odds, at positions drawn uniformly over the query.
All of it is drawn from the run's seed in a few vectorised calls.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
KEYS = ("length", "error_rate", "pairs_per_call", "pool_calls",
        "warmup_calls", "trace_calls", "check_per_call",
        "check_retried_per_call")
Pair = Tuple[bytes, bytes]


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one use of the seed (0 the pairs, 1 the sample);
    any whole number is a seed, negative ones too."""
    return np.random.default_rng([seed & (2**64 - 1), stream])


def make_pairs(gen: np.random.Generator, n: int, length: int,
               error_rate: float) -> List[Pair]:
    """n (query, target) pairs of ``length``-base queries."""
    q = BASES[gen.integers(0, 4, size=(n, length))]
    n_err = int(round(length * error_rate))
    kind = gen.integers(0, 3, size=(n, n_err))
    pos = gen.integers(0, length, size=(n, n_err))
    base = BASES[gen.integers(0, 4, size=(n, n_err))]
    row = np.broadcast_to(np.arange(n)[:, None], (n, n_err))
    t = q.copy()
    sub, dele, ins = kind == 0, kind == 1, kind == 2
    t[row[sub], pos[sub]] = base[sub]
    keep = np.ones((n, length), bool)
    keep[row[dele], pos[dele]] = False
    # an insertion goes in front of its position, in the row it belongs to
    at = row[ins] * length + pos[ins]
    flat = np.insert(t.reshape(-1), at, base[ins])
    kept = np.insert(keep.reshape(-1), at, True)
    tlen = keep.sum(axis=1) + ins.sum(axis=1)
    tbytes = flat[kept].tobytes()
    qbytes = q.tobytes()
    ends = np.cumsum(tlen).tolist()
    starts = [0] + ends[:-1]
    return [(qbytes[i * length:(i + 1) * length], tbytes[a:b])
            for i, (a, b) in enumerate(zip(starts, ends))]


def make_pool(mix: dict, seed: int) -> List[List[Pair]]:
    """The distinct calls of a run: ``pool_calls`` lists of
    ``pairs_per_call`` pairs."""
    n, calls = mix["pairs_per_call"], mix["pool_calls"]
    pairs = make_pairs(rng(seed, 0), n * calls, mix["length"],
                       mix["error_rate"])
    return [pairs[c * n:(c + 1) * n] for c in range(calls)]


def sample(mix: dict, seed: int, parts: int) -> List[List[int]]:
    """For each call of the pool, the positions whose results a run
    checks: the first and the last row of each of ``parts`` equal slices
    of the call (the cards a batch is split over, whose edges a shard's
    fault would show at), and ``check_per_call`` more drawn from the seed
    between them, spread evenly over the slices; in ascending order."""
    gen = rng(seed, 1)
    n, per = mix["pairs_per_call"], mix["check_per_call"]
    bounds = np.linspace(0, n, parts + 1).astype(int)
    out = []
    for _ in range(mix["pool_calls"]):
        idx = []
        for p in range(parts):
            lo, hi = int(bounds[p]), int(bounds[p + 1])
            if hi <= lo:
                continue
            idx += sorted({lo, hi - 1})
            inner = hi - lo - 2
            k = min(per // parts + (p < per % parts), max(inner, 0))
            if k:
                idx += (lo + 1 + gen.choice(inner, size=k,
                                            replace=False)).tolist()
        out.append(sorted(idx))
    return out
