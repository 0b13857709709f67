"""The port's scores against an independent Gotoh DP, on the CPU.

``wfa_tpu_torch.dp.dp_score`` is a classic O(n·m) gap-affine dynamic
program written apart from the wavefront recurrences; here it holds
``BatchAligner(device="cpu")`` (the kernel wrappers' plain versions) and
``AlignmentPipeline(device="cpu")`` to the optimal score, in global and
semi-global mode, at the penalties of ``tests/test_oracle_vs_dp.py``,
on seeded pairs of up to 60 bases.  This check needs neither JAX nor the
oracle.  Wf-adaptive reduction is off: it is a heuristic and may trade
optimality for speed.  Scores are integers: the tolerance is equality.
"""

import random

import pytest
import torch

from wfa_tpu_torch import Options, Penalties
from wfa_tpu_torch.dp import dp_score
from wfa_tpu_torch.engine import BatchAligner
from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

torch.set_num_threads(2)

N_PAIRS = 24


def _pairs(rng: random.Random) -> list:
    """Pairs of 1-60 bases, the target a mutation of the query at a rate
    of 2-80% (substitutions, deletions, insertions alike)."""
    pairs = []
    for _ in range(N_PAIRS):
        q = "".join(rng.choice("ACGT") for _ in range(rng.randint(1, 60)))
        rate = rng.choice([0.02, 0.05, 0.1, 0.3, 0.8])
        t = []
        for ch in q:
            r = rng.random()
            if r < rate / 3:
                t.append(rng.choice("ACGT"))
            elif r < 2 * rate / 3:
                pass
            elif r < rate:
                t += [ch, rng.choice("ACGT")]
            else:
                t.append(ch)
        pairs.append((q.encode(), ("".join(t) or rng.choice("ACGT")).encode()))
    return pairs


@pytest.mark.parametrize("global_alignment", [True, False],
                         ids=["global", "semi"])
@pytest.mark.parametrize("penalties", [
    Penalties(4, 6, 2),
    Penalties(2, 3, 1),
    Penalties(1, 4, 1),
    Penalties(5, 1, 1),
], ids=lambda p: f"{p.mismatch}-{p.gap_open}-{p.gap_ext}")
def test_scores_match_dp(global_alignment, penalties):
    """Every pair's score, from one batch of the plain score loop at caps
    that hold it (semi-global at the full span) and from the pipeline's
    tier ladder, equals the DP's; no pair goes to the oracle."""
    rng = random.Random(hash((global_alignment, penalties.mismatch,
                              penalties.gap_open, penalties.gap_ext)) & 0xFFFF)
    pairs = _pairs(rng)
    want = [dp_score(q, t, penalties, global_alignment) for q, t in pairs]
    longest = max(max(len(q), len(t)) for q, t in pairs)
    spread = max(abs(len(q) - len(t)) for q, t in pairs)
    s_cap = -(-(penalties.mismatch * longest + penalties.gap_open
                + penalties.gap_ext * (spread + 1) + 8) // 8) * 8
    k_win = -(-(2 * longest + 2) // 128) * 128
    eng = BatchAligner(penalties, Options(global_alignment), None,
                       k_win=k_win, s_cap=s_cap, device="cpu")
    got = eng.align_batch(pairs, fallback=False)
    assert [r.score if r is not None else None for r in got] == want
    pipe = AlignmentPipeline(PipelineConfig(
        penalties, Options(global_alignment), None, batch_size=16,
        device="cpu"))
    got = pipe.align_all(pairs)
    pipe.close()
    assert pipe.served["oracle"] == 0, pipe.served
    assert [r.score for r in got] == want
