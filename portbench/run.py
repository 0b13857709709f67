"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` names the cell).  A run
makes the cell's inputs from the seed (``portbench.traffic``), builds one ``AlignmentPipeline`` from
the configuration file and warms it on the cell's own calls, then drives
``align_all`` in a closed loop for ``--seconds``: one caller, the next
call once the last has returned, cycling through the pool of distinct
calls.  It keeps each call's wall time, the scores at the sampled
positions of every call and the sampled results of the last call of each
input, and checks them against the plain reference once the window has
closed.  ``--trace 1`` profiles a slice of the window and reads the
per-layer metrics (``portbench.trace``).

Earlier lines of standard error, and a line of ``.portbench/runs.jsonl``
in the checkout, carry the run's host covariates; its last lines on
standard error are the numbers compared, each beside its limit.  The
last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from . import check, host, manifest, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "wfa_tpu")
LOG = Path(".portbench") / "runs.jsonl"


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class GcWatch:
    """Collections and their pauses by generation (``gc.callbacks``)."""

    def __init__(self) -> None:
        self.count = [0, 0, 0]
        self.pause = [0.0, 0.0, 0.0]
        self._t = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.count[g] += 1
            self.pause[g] += time.perf_counter() - self._t

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)
        return False


def pipeline_config(config: dict, device: str, n_devices=None):
    """The ``PipelineConfig`` a configuration file states."""
    from wfa_tpu_torch import (AdaptiveReductionOption, Options, Penalties,
                               PipelineConfig)

    ad = config.get("adaptive")
    return PipelineConfig(
        penalties=Penalties(**config["penalties"]),
        options=Options(global_alignment=config["global_alignment"]),
        adaptive=None if ad is None else AdaptiveReductionOption(**ad),
        batch_size=config["batch_size"], device=device,
        n_devices=config["n_devices"] if n_devices is None else n_devices)


class Bench:
    """One run of a cell: set-up, window, check.  ``device`` "cuda" on the
    card; "cpu" runs the program's plain versions (the harness's tests)."""

    def __init__(self, cell: manifest.Cell, seed: int, *, device: str,
                 origin: float, split: Dict[str, float],
                 n_devices: Optional[int] = None) -> None:
        self.cell, self.seed, self.device = cell, seed, device
        self.origin, self.split = origin, split
        self.mix = cell.mix
        self.n_devices = n_devices
        self.notes: List[str] = []

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from wfa_tpu_torch.pipeline import AlignmentPipeline

        t = time.perf_counter()
        self.pool = traffic.make_pool(self.mix, self.seed)
        self.sample = traffic.sample(self.mix, self.seed, self.cell.chips)
        self.split["data"] = time.perf_counter() - t
        t = time.perf_counter()
        self.pipe = AlignmentPipeline(pipeline_config(
            self.cell.config, self.device, self.n_devices))
        P = len(self.pool)
        retried = [set() for _ in range(P)]
        self.warm_calls = []
        warmup = self.mix["warmup_calls"]
        for i in range(warmup):
            t0 = time.perf_counter()
            if i >= warmup - P:  # the last pass: note the retries
                with _RetryProbe(self.pool, retried):
                    self.pipe.align_all(self.pool[i % P])
            else:
                self.pipe.align_all(self.pool[i % P])
            self.warm_calls.append(
                [time.perf_counter() - t0, gc.get_stats()[2]["collections"]])
        gen = traffic.rng(self.seed, 2)
        k = self.mix["check_retried_per_call"]
        for p in range(P):
            extra = sorted(retried[p] - set(self.sample[p]))
            if len(extra) > k:
                extra = sorted(gen.choice(extra, size=k, replace=False))
            self.sample[p] = sorted(self.sample[p] + [int(i) for i in extra])
        self.retried_seen = sum(len(r) for r in retried)
        self.split["warmup"] = time.perf_counter() - t

    # -- the window -----------------------------------------------------------

    def _call(self, i: int) -> float:
        p = i % len(self.pool)
        t0 = time.perf_counter()
        res = self.pipe.align_all(self.pool[p])
        wall = time.perf_counter() - t0
        kept = [res[j] for j in self.sample[p]]
        self.kept[p] = kept
        self.scores.append((p, [None if r is None else r.score
                                for r in kept]))
        self.missing += res.count(None)
        return wall

    def window(self, seconds: float, traced: bool) -> dict:
        self.kept: Dict[int, list] = {}
        self.scores: List[tuple] = []
        self.missing = 0
        n = self.mix["pairs_per_call"]
        ctx: dict = {}
        calls: List[float] = []
        watch = host.HostWatch()
        with GcWatch() as gcw:
            t0 = time.perf_counter()
            self.setup_s = t0 - self.origin
            i = 0
            if traced:
                i, rest = self._traced_slice(ctx)
                calls += rest
            rest_t0 = time.perf_counter()
            gc_rest0 = sum(gcw.pause)
            if traced:
                inst = self.inst
                thread0 = dict(inst.thread_s)
                launches0 = inst.launch_count()
            rest: List[float] = []
            while time.perf_counter() - t0 < seconds:
                rest.append(self._call(i))
                i += 1
            end = time.perf_counter()
        calls += rest
        self.host = watch.read()
        self.gc = {"count": gcw.count, "pause_s": gcw.pause}
        self.calls = calls
        if traced:
            inst.uninstall()
            ctx.update({
                "calls_s": rest, "pairs": n * len(rest),
                "rest_s": end - rest_t0,
                "gc_pause_s": sum(gcw.pause) - gc_rest0,
                "thread_s": {k: v - thread0.get(k, 0.0)
                             for k, v in inst.thread_s.items()},
                "launches": inst.launch_count() - launches0})
        e2e = {"calls_s": calls, "pairs": n * len(calls),
               "window_s": end - t0, "setup_s": self.setup_s}
        return ctx if traced else e2e

    def _traced_slice(self, ctx: dict):
        """The profiled slice: the traffic's ``trace_calls`` calls under
        ``torch.profiler``, with the host spans and each kernel launch
        recorded; returns (calls made, their walls)."""
        import torch

        from . import trace

        self.inst = trace.Instrument()
        self.inst.install()
        walls: List[float] = []

        def calls():
            for i in range(self.mix["trace_calls"]):
                t0 = time.perf_counter()
                with torch.profiler.record_function("call"):
                    walls.append(self._call(i))
                self.inst.spans.append(("call", t0, time.perf_counter()))

        self.inst.profiling = True
        try:
            tr = trace.profile(calls, self.device == "cuda", self.inst.spans)
        finally:
            self.inst.profiling = False
        busy_s, slice_s = trace.busy(tr, self.cell.chips)
        ctx.update({"roofline": self.inst.roofline(),
                    "kernel_s": tr["kernel_s"], "busy_s": busy_s,
                    "slice_s": slice_s})
        self.breakdown = trace.breakdown(tr)
        self.busy = (busy_s, slice_s)
        if self.inst.missing:
            self.notes.append("not wrapped (absent from the program): "
                              + ", ".join(self.inst.missing))
        return len(walls), walls

    # -- the check ------------------------------------------------------------

    def memory_peak(self) -> int:
        if self.device != "cuda":
            return 0
        import torch

        return max(torch.cuda.max_memory_allocated(d)
                   for d in range(self.cell.chips))

    def check(self) -> Dict[str, dict]:
        """The numbers compared, each with its limit: the sampled results
        of the last call of each input against the reference's answers,
        and the sampled scores of every call.  Frees the program's state
        first."""
        got = {p: [check.program_answer(r) for r in rs]
               for p, rs in self.kept.items()}
        self.kept = {}
        self.pipe.close()
        del self.pipe
        gc.collect()
        if self.device == "cuda":
            import torch

            torch.cuda.empty_cache()
        pairs = [self.pool[p][j] for p in sorted(got) for j in self.sample[p]]
        ref = iter(check.reference_answers(
            pairs, check.aligner_args(self.cell.config)))
        want = {p: [next(ref) for _ in self.sample[p]] for p in sorted(got)}
        mismatched = sum(g != w for p in got for g, w in zip(got[p], want[p])
                         if g is not None)
        missing = self.missing + sum(g is None for p in got for g in got[p])
        scores = sum(s != w[0] for p, ss in self.scores
                     for s, w in zip(ss, want[p]))
        self.checked = len(pairs)
        return {"mismatched_pairs": {"value": mismatched, "limit": 0},
                "mismatched_scores": {"value": scores, "limit": 0},
                "missing_results": {"value": missing, "limit": 0}}


class _RetryProbe:
    """Within the block, notes the positions of the pairs a tier's batch
    gave back unserved (``BatchAligner.finish_tokens`` with the fallback
    off returns None for them): the pairs the ladder retries."""

    def __init__(self, pool, into) -> None:
        self.where = {id(q): (p, i) for p, call in enumerate(pool)
                      for i, (q, _) in enumerate(call)}
        self.into = into

    def __enter__(self):
        from wfa_tpu_torch.engine import BatchAligner

        self.orig = orig = BatchAligner.finish_tokens
        probe = self

        def finish_tokens(eng, h, fallback=True):
            out = orig(eng, h, fallback)
            for (q, _), r in zip(h.pairs, out):
                if r is None and id(q) in probe.where:
                    p, i = probe.where[id(q)]
                    probe.into[p].add(i)
            return out

        BatchAligner.finish_tokens = finish_tokens
        return self

    def __exit__(self, *exc):
        from wfa_tpu_torch.engine import BatchAligner

        BatchAligner.finish_tokens = self.orig
        return False


def run_cell(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
             *, device: str, origin: float, split: Dict[str, float],
             n_devices: Optional[int] = None, kind: str = "cpu") -> dict:
    """Set up, run the window and check one cell (no look for a chip);
    returns the result line's object and the run's record."""
    bench = Bench(cell, seed, device=device, origin=origin, split=split,
                  n_devices=n_devices)
    bench.setup()
    ctx = bench.window(seconds, traced)
    peak = bench.memory_peak()
    after = host.card_state(host.Cards().read()) if device == "cuda" else []
    compared = bench.check()
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    metrics = manifest.read_all(cell.per_layer if traced else cell.end_to_end,
                                ctx)
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": kind,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct,
              "attempted": bench.mix["pairs_per_call"] * len(bench.calls),
              "failed": bench.missing, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"], dev["window_s"] = bench.busy
        result["breakdown"] = bench.breakdown
    result["check"] = compared
    calls = sorted(bench.calls)
    record = {
        "calls_ms": [round(1e3 * c, 3) for c in bench.calls],
        "workload": cell.name, "seed": seed, "trace": int(traced),
        "setup_s": bench.setup_s, "split": split,
        "window": {"calls": len(calls),
                   "median_ms": 1e3 * calls[len(calls) // 2],
                   "max_ms": 1e3 * calls[-1]},
        "warmup_calls": bench.warm_calls, "retried_seen": bench.retried_seen,
        "checked": bench.checked, "host": bench.host, "gc": bench.gc,
        "cards_after": after, "notes": bench.notes,
        "metrics": {k: v["value"] for k, v in metrics.items()}}
    return {"result": result, "record": record}


def main(argv=None) -> int:
    origin = time.perf_counter() - host.exec_seconds()
    args = _parse(argv)
    root = Path.cwd()
    try:
        cell = manifest.cell(manifest.load(root), args.workload, root)
    except (OSError, KeyError, ValueError) as exc:
        print(f"portbench: no cell {args.workload!r} here ({exc!r})",
              file=sys.stderr)
        return 2
    cards = host.Cards()  # read while torch is imported
    t = time.perf_counter()
    try:
        import torch

        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < cell.chips:
            print(f"portbench: {cell.name} needs {cell.chips} CUDA "
                  f"device(s), found {found}", file=sys.stderr)
            return 2
        try:
            import wfa_tpu_torch.pipeline  # noqa: F401  the program
        except ImportError as exc:
            print(f"portbench: the program is not here ({exc})",
                  file=sys.stderr)
            return 2
    finally:
        before = host.card_state(cards.read())
    split = {"start": t - origin, "import": time.perf_counter() - t}
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   device="cuda", origin=origin, split=split,
                   kind=torch.cuda.get_device_name(0))
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        print(f"portbench: the process loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    rec = dict(out["record"], placement=cell.config["placement"],
               cards_before=before)
    LOG.parent.mkdir(exist_ok=True)
    with open(LOG, "a") as fh:
        fh.write(json.dumps(rec) + "\n")
    res = out["result"]
    w = rec["window"]
    print(f"portbench: {cell.name} seed {args.seed} placement "
          f"{rec['placement']}", file=sys.stderr)
    print("portbench: set-up {:.3f} s: {}".format(rec["setup_s"], ", ".join(
        f"{k} {v:.3f}" for k, v in rec["split"].items())), file=sys.stderr)
    print(f"portbench: window {w['calls']} calls, median "
          f"{w['median_ms']:.3f} ms, max {w['max_ms']:.3f} ms; gc "
          f"{rec['gc']}; host {rec['host']}", file=sys.stderr)
    print(f"portbench: cards {rec['cards_before']} -> {rec['cards_after']}",
          file=sys.stderr)
    for note in rec["notes"]:
        print(f"portbench: {note}", file=sys.stderr)
    print(f"portbench: checked {rec['checked']} results against the "
          "reference", file=sys.stderr)
    for name, v in res["check"].items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
