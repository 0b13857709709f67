"""What decides ``correct``: the sampled results of the window against the
plain reference (:mod:`portbench.reference`), answer for answer.

The reference runs after the window has closed, in worker processes, one
a core the run may use: each a fresh interpreter that imports the
reference and NumPy alone, fed its pairs and returning its answers over
pipes (pickled by this module on both sides).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from typing import List, Optional, Sequence, Tuple

from .reference import Aligner, answer

_WORKER = "from portbench.check import _serve; _serve()"


def aligner_args(config: dict, gap_first: bool = False) -> tuple:
    """The reference aligner's arguments for a configuration file."""
    p, ad = config["penalties"], config.get("adaptive")
    return ((p["mismatch"], p["gap_open"], p["gap_ext"]),
            config["global_alignment"],
            None if ad is None else (ad["min_wf_len"], ad["max_dist_diff"]),
            gap_first)


def _answers(pairs, args) -> List[tuple]:
    aligner = Aligner(*args)
    return [answer(aligner.align(q, t)) for q, t in pairs]


def _serve() -> None:
    """A worker: (pairs, args) on standard input, answers on output."""
    pairs, args = pickle.load(sys.stdin.buffer)
    pickle.dump(_answers(pairs, args), sys.stdout.buffer)
    sys.stdout.flush()


def reference_answers(pairs: Sequence[Tuple[bytes, bytes]], args: tuple,
                      workers: Optional[int] = None) -> List[tuple]:
    """The reference's answer for each pair."""
    n = min(len(pairs), workers or len(os.sched_getaffinity(0)))
    if n <= 1:
        return _answers(pairs, args)
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE)
             for _ in range(n)]
    try:
        for w, proc in enumerate(procs):
            pickle.dump((list(pairs[w::n]), args), proc.stdin)
            proc.stdin.close()
        parts = [pickle.load(proc.stdout) for proc in procs]
    except BaseException:
        for proc in procs:
            proc.kill()
        raise
    finally:
        for proc in procs:
            proc.stdout.close()
            proc.wait()
    out: List[tuple] = [()] * len(pairs)
    for w, part in enumerate(parts):
        out[w::n] = part
    return out


def program_answer(res) -> Optional[tuple]:
    """A program result's answer, None for a result that is missing or
    carries an error."""
    if res is None or getattr(res, "error", None) is not None:
        return None
    try:
        return answer(res)
    except (AssertionError, ValueError, IndexError, KeyError) as exc:
        return ("undecodable", repr(exc))  # equals no reference answer
