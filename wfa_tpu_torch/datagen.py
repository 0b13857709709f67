"""Synthetic benchmark dataset generation.

Mimics the WFA `generate_dataset` tool used by the reference's benchmark
protocol (reference README.md:300-306): n pairs of length l, the second
sequence derived from the first by point errors at rate e (substitutions,
insertions, deletions in equal proportion).  Deterministic per seed.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def generate_pairs(
    n: int, length: int, error_rate: float, seed: int = 42
) -> List[Tuple[bytes, bytes]]:
    """n (query, target) pairs: query random, target = query + errors."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        q = _BASES[rng.integers(0, 4, size=length)]
        n_err = int(round(length * error_rate))
        t = list(q.tobytes())
        for _ in range(n_err):
            if not t:
                break
            kind = rng.integers(0, 3)
            pos = int(rng.integers(0, len(t)))
            if kind == 0:  # substitution
                t[pos] = int(_BASES[rng.integers(0, 4)])
            elif kind == 1:  # deletion
                del t[pos]
            else:  # insertion
                t.insert(pos, int(_BASES[rng.integers(0, 4)]))
        tb = bytes(t) or b"A"
        pairs.append((q.tobytes(), tb))
    return pairs


def write_pair_file(path: str, pairs) -> None:
    """Write pairs in the WFA-paper benchmarking format."""
    with open(path, "wb") as fh:
        for q, t in pairs:
            fh.write(b">" + q + b"\n<" + t + b"\n")
