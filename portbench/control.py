"""The control: the reference with one guarantee broken, put in the
program's place, must come out not correct.

    python3 -m portbench.control --workload <name> --seeds 1,2,3

For each seed it makes the cell's inputs and the positions a run samples,
as a run does, answers them with ``reference.Aligner(..., gap_first=True)``
(a gap wins its ties with a mismatch: the scores stay optimal and the
CIGARs change) and counts the numbers a run compares against the exact
reference's answers.  It needs no card; it runs at the cell's own size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from . import check, manifest, traffic


def readings(cell: manifest.Cell, seed: int) -> dict:
    pool = traffic.make_pool(cell.mix, seed)
    sample = traffic.sample(cell.mix, seed, cell.chips)
    pairs = [pool[p][j] for p, idx in enumerate(sample) for j in idx]
    args = check.aligner_args(cell.config)
    ref = check.reference_answers(pairs, args)
    got = check.reference_answers(pairs, args[:-1] + (True,))
    return {"mismatched_pairs": sum(g != w for g, w in zip(got, ref)),
            "mismatched_scores": sum(g[0] != w[0] for g, w in zip(got, ref)),
            "missing_results": 0, "checked": len(pairs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cell = manifest.cell(manifest.load(root), args.workload, root)
    out = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out[seed] = readings(cell, seed)
        print(f"control {cell.name} seed {seed}: {out[seed]} "
              f"({time.perf_counter() - t:.1f} s)", file=sys.stderr)
    print(json.dumps({"workload": cell.name, "control": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
