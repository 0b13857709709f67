"""Run a series of benchmark runs one after another and summarise them: how
the bounds of PERF.md were measured.

    python3 -m portbench.series --out DIR --seconds 20 \
        --job global.l50000-e05:11 --job global.l50000-e05:12

Each job is ``workload:seed``, run as its own process in the order given,
its standard output and error kept in DIR.  The summary groups the runs
by workload and gives each metric's values, its spread between quartiles and its range
less the run farthest from the median, each as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

from .stats import iqr_share, trimmed_range_share


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.series")
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--job", action="append", required=True)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    groups = defaultdict(list)
    for n, job in enumerate(args.job):
        workload, seed = job.split(":")
        cmd = [sys.executable, "-m", "portbench.run", "--workload", workload,
               "--seed", seed, "--seconds", str(args.seconds),
               "--trace", str(args.trace)]
        t = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        wall = time.perf_counter() - t
        tag = f"{n:03d}_{workload}_{seed}"
        (out / f"{tag}.out").write_text(proc.stdout)
        (out / f"{tag}.err").write_text(proc.stderr)
        lines = proc.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            res = None
        row = {"job": job, "rc": proc.returncode, "wall_s": wall,
               "correct": res and res["correct"],
               "metrics": {k: v["value"] for k, v in
                           (res["metrics"].items() if res else ())}}
        groups[workload].append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for key, rows in groups.items():
        names = sorted({m for r in rows for m in r["metrics"]})
        summary[key] = {}
        for m in names:
            vals = [r["metrics"][m] for r in rows if m in r["metrics"]]
            s = {"values": vals, "median": statistics.median(vals)}
            if len(vals) >= 3:
                s["iqr_share"] = iqr_share(vals)
                s["trimmed_range_share"] = trimmed_range_share(vals)
            summary[key][m] = s
        summary[key]["all_correct"] = all(r["correct"] for r in rows)
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
