"""The port's recorder (``wfa_tpu_torch.trace``) on the CPU: one record a
``align_all`` call, its spans nested as call > batch > submit | drain >
the rest on their threads, its counters (pairs, batches, bytes, a forced
refetch, the mesh's shards and launches), the bounded history, the
benchmark's readers of the records, and the CLI's profile with the
program's spans merged in on the profiler's clock."""

import collections
import json
import time
from pathlib import Path

import pytest

from wfa_tpu_torch import AdaptiveReductionOption, Options, Penalties, trace
from wfa_tpu_torch.datagen import generate_pairs
from wfa_tpu_torch.pipeline import AlignmentPipeline, PipelineConfig

ROOT = Path(__file__).resolve().parents[1]
# the SMALL mix of portbench/tests/test_portbench_faults.py
SMALL = {"length": 240, "pairs_per_call": 16, "pool_calls": 2,
         "warmup_calls": 2, "trace_calls": 1, "check_per_call": 16,
         "check_retried_per_call": 2}
# every span a batch's submit or drain holds, by the parent's kind
CHILDREN = {"submit": ("pack", "upload", "launch", "shard"),
            "drain": ("wait", "build")}
NEW_METRICS = ("pack_ms_per_kpair", "upload_ms_per_kpair",
               "launch_ms_per_kpair", "device_wait_ms_per_kpair",
               "build_ms_per_kpair", "queue_wait_ms_per_kpair",
               "host_stall_pct", "refetch_pct", "pack_vector_pct")


def _pipe(**kw):
    return AlignmentPipeline(PipelineConfig(
        Penalties(4, 6, 2), Options(True), AdaptiveReductionOption(10, 50, 1),
        device="cpu", **kw))


def _spans(tl):
    return [(e["name"], e["args"]["call"], e["args"]["batch"],
             e["args"]["shard"], e["tid"], e["ts"], e["ts"] + e["dur"])
            for e in tl.chrome_events({})]


def _inside(child, parent):
    return parent[5] <= child[5] and child[6] <= parent[6]


def test_one_call_one_record_with_its_spans_nested():
    pairs = generate_pairs(24, 200, 0.02, seed=31)
    pipe = _pipe(batch_size=8, n_devices=1)
    try:
        with trace.timeline() as tl:
            res = pipe.align_all(pairs)
    finally:
        pipe.close()
    assert all(r is not None and r.error is None for r in res)
    assert pipe.served[0] == len(pairs)
    rec = trace.records(1)[0]
    assert rec["pairs"] == len(pairs) and rec["batches"] == 3
    n = {k: v["count"] for k, v in rec["spans"].items()}
    assert n["call"] == 1
    for kind in ("queue", "submit", "pack", "launch", "drain", "build"):
        assert n[kind] == 3, kind
    for kind in ("gate", "upload", "wait"):
        assert n[kind] == 6, kind
    assert set(rec["spans"]["pack"]) == {"wall_ns", "count", "cpu_ns"}
    assert set(rec["spans"]["wait"]) == {"wall_ns", "count"}
    assert "shard" not in n
    assert rec["bytes_up"] > 0 and rec["bytes_down"] > 0
    assert rec["refetches"] == 0
    assert rec["peak"]["batches"] >= 1
    spans = _spans(tl)
    assert {s[1] for s in spans} == {rec["call"]}
    call = [s for s in spans if s[0] == "call"]
    assert len(call) == 1
    call = call[0]
    for s in spans:
        assert _inside(s, call) or s[0] == "queue", s
        if s[0] == "gate":
            assert s[4] == call[4] and s[2] == -1
    for b in range(3):
        mine = [s for s in spans if s[2] == b]
        assert {s[0] for s in mine} == {
            "queue", "submit", "pack", "upload", "launch", "drain", "wait",
            "build"}
        for parent_kind, kinds in CHILDREN.items():
            (parent,) = [s for s in mine if s[0] == parent_kind]
            for s in mine:
                if s[0] in kinds:
                    assert s[4] == parent[4] and _inside(s, parent), s
        (queue,) = [s for s in mine if s[0] == "queue"]
        (submit,) = [s for s in mine if s[0] == "submit"]
        assert queue[4] == submit[4] and queue[6] <= submit[5]


def test_a_forced_extent_miss_counts_one_refetch():
    pairs = generate_pairs(8, 200, 0.02, seed=32)
    pipe = _pipe(batch_size=8, n_devices=1)
    try:
        want = pipe.align_all(pairs)
        assert pipe.served[0] == len(pairs)
        assert trace.records(1)[0]["refetches"] == 0
        for eng in pipe._engines.values():
            eng._tok_guess = {"mtb": 1, "lg": 1, "buf": 1}
        got = pipe.align_all(pairs)
    finally:
        pipe.close()
    rec = trace.records(1)[0]
    assert rec["batches"] == 1 and rec["refetches"] == 1
    # the second copy is queued under a launch span of the drain
    assert rec["spans"]["launch"]["count"] == 2
    assert rec["spans"]["wait"]["count"] == 2
    assert [(r.score, r.cigar(False)) for r in got] == [
        (r.score, r.cigar(False)) for r in want]


def test_every_nth_call_reads_the_cpu_clock(monkeypatch):
    """Every call's pack and build spans read their thread's CPU clock
    (n is 1), and the spans of no other kind read it."""
    ticks = iter(range(0, 10**12, 1000))
    monkeypatch.setattr(trace, "_cpu", lambda: next(ticks))
    pairs = generate_pairs(2, 60, 0.02, seed=36)
    pipe = _pipe(batch_size=2, n_devices=1)
    try:
        for _ in range(4):
            pipe.align_all(pairs)
    finally:
        pipe.close()
    recs = trace.records(4)
    for rec in recs:
        for kind, sp in rec["spans"].items():
            if kind in ("pack", "build"):
                # one tick between a span's two reads of the stub
                assert sp["cpu_ns"] == 1000 * sp["count"] > 0, rec
            else:
                assert "cpu_ns" not in sp, rec
    # two reads a pack and a build span, and no other read of the clock
    n = sum(rec["spans"][k]["count"] for rec in recs
            for k in ("pack", "build"))
    assert next(ticks) == 2 * n * 1000


def test_the_history_stays_bounded(monkeypatch):
    assert trace.history.maxlen == trace.HISTORY
    monkeypatch.setattr(trace, "history", collections.deque(maxlen=3))
    pipe = AlignmentPipeline(PipelineConfig(use_device=False))
    pairs = [(b"ACGTACGT", b"ACGTTCGT")] * 2
    for _ in range(5):
        pipe.align_all(pairs)
    recs = trace.records()
    assert len(recs) == 3 and len(trace.history) == 3
    ids = [r["call"] for r in recs]
    assert ids == list(range(ids[0], ids[0] + 3))
    assert all(r["pairs"] == 2 and r["batches"] == 0 for r in recs)


def test_a_two_shard_mesh_gives_two_shard_spans_a_batch():
    pairs = generate_pairs(16, 200, 0.02, seed=33)
    pipe = _pipe(batch_size=8, n_devices=2)
    assert pipe._mesh is not None and pipe._mesh.size == 2
    try:
        with trace.timeline() as tl:
            pipe.align_all(pairs)
    finally:
        pipe.close()
    rec = trace.records(1)[0]
    assert rec["batches"] == 2
    assert rec["spans"]["shard"]["count"] == 4
    assert rec["shard_steps"] == 2 and rec["shard_lag_ns"] > 0
    spans = _spans(tl)
    for b in range(2):
        shards = [s for s in spans if s[2] == b and s[0] == "shard"]
        assert sorted(s[3] for s in shards) == [0, 1]
        (submit,) = [s for s in spans if s[2] == b and s[0] == "submit"]
        for sh in shards:
            assert sh[4] == submit[4] and _inside(sh, submit)
            inner = [s for s in spans if s[2] == b and s[3] == sh[3]
                     and s[0] in ("upload", "launch")]
            assert {s[0] for s in inner} == {"upload", "launch"}
            assert all(s[4] == sh[4] and _inside(s, sh) for s in inner)


def test_nested_tallies_count_a_shards_launches_once_each():
    from wfa_tpu_torch._build import count
    from wfa_tpu_torch.kernel_engine import run_batch
    from wfa_tpu_torch.parallel import DpMesh, shard_launches

    mesh = DpMesh(["cpu", "cpu"])
    with trace.call(0, {}):
        with trace.batch(trace.next_batch()):
            for i in range(2):
                with mesh.on(i):
                    count(run_batch.launches, "global")
    rec = trace.records(1)[0]
    assert rec["launches"] == 2 and rec["batches"] == 1
    assert shard_launches(mesh) == [{"score_loop": {"global": 1}}] * 2


def test_a_worker_takes_the_tid_of_its_runtime_calls():
    """In a trace whose CUDA runtime calls carry ids of CUPTI's own, each
    worker's spans take the id of the calls inside its spans; the caller,
    whose operators the trace records, keeps its native id."""
    import threading

    pairs = generate_pairs(16, 200, 0.02, seed=35)
    pipe = _pipe(batch_size=8, n_devices=1)
    try:
        with trace.timeline() as tl:
            pipe.align_all(pairs)
    finally:
        pipe.close()
    me = threading.get_native_id()
    fake = {"traceEvents": [{"ph": "X", "cat": "cpu_op", "tid": me,
                             "ts": 0, "dur": 1}]}
    off = tl.offset_ns(fake)
    workers = set()
    for kind, _, _, _, tid, t0, t1, _ in tl.events:
        if kind in (trace.UPLOAD, trace.LAUNCH, trace.WAIT):
            workers.add(tid)
            fake["traceEvents"].append(
                {"ph": "X", "cat": "cuda_runtime", "tid": 10**9 + tid,
                 "ts": (t0 + (t1 - t0) // 2 + off) / 1e3, "dur": 0})
    assert me not in workers and len(workers) >= 2  # a submit, a drain
    got = {(e["args"]["native_tid"], e["tid"])
           for e in tl.chrome_events(fake)}
    assert got == {(me, me)} | {(w, 10**9 + w) for w in workers}
    assert {(e["args"]["native_tid"], e["tid"])
            for e in tl.chrome_events({})} == {(me, me)} | {
        (w, w) for w in workers}


def test_spans_off_a_call_record_nothing():
    before = len(trace.history)
    with trace.span(trace.PACK):
        trace.count(trace.BYTES_UP, 10)
    assert trace.next_batch() is None
    assert len(trace.history) == before


def _run_cell(name, n_devices=None):
    from portbench import manifest, run

    cell = manifest.cell(manifest.load(ROOT), name, ROOT)
    cell.mix = dict(cell.mix, **SMALL)
    # a window long enough that calls follow the profiled slice on a busy
    # host: the readers read those calls
    return run.run_cell(cell, 2**31 + 13, 10.0, True, device="cpu",
                        origin=time.perf_counter(), split={},
                        n_devices=n_devices)["result"]


@pytest.mark.parametrize("name", ["global.l50000-e05",
                                  "global.l50000-e05.x4"])
def test_a_traced_cell_reads_every_new_metric(name):
    x4 = name.endswith("x4")
    res = _run_cell(name, n_devices=2 if x4 else None)
    assert res["correct"], res["check"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    want = NEW_METRICS + (("shard_launch_lag_ms",) if x4 else ())
    assert set(want) <= set(got), sorted(got)
    if not x4:
        assert "shard_launch_lag_ms" not in got
    for k in ("pack_ms_per_kpair", "upload_ms_per_kpair",
              "launch_ms_per_kpair", "build_ms_per_kpair"):
        assert got[k] > 0, k
    assert got["device_wait_ms_per_kpair"] >= 0
    assert got["queue_wait_ms_per_kpair"] >= 0
    assert 0 <= got["refetch_pct"] <= 100
    assert got["host_stall_pct"] <= 100
    # every batch of the cell is pure ACGT: the direct pack packs them all
    from wfa_tpu_torch import native

    assert got["pack_vector_pct"] == (100.0 if native.load().wfa_pack_vector()
                                      else 0.0)


def test_a_reader_needs_the_records_to_match_the_window():
    from portbench import manifest

    pipe = AlignmentPipeline(PipelineConfig(use_device=False))
    pairs = [(b"ACGTACGT", b"ACGTTCGT")] * 3
    for _ in range(2):
        pipe.align_all(pairs)
    read = manifest.reader("pack_ms_per_kpair")
    refetch = manifest.reader("refetch_pct")
    assert read({"calls_s": [0.1, 0.1], "pairs": 6}) == 0.0
    assert refetch({"calls_s": [0.1, 0.1], "pairs": 6}) is None  # 0 batches
    assert read({"calls_s": [0.1] * 2, "pairs": 7}) is None
    assert read({"calls_s": [0.1] * (len(trace.history) + 1),
                 "pairs": 3 * (len(trace.history) + 1)}) is None
    assert read({"calls_s": [], "pairs": 0}) is None


def test_the_cli_profile_carries_the_programs_spans(tmp_path, capsys):
    from wfa_tpu_torch import cli

    q, t = generate_pairs(1, 150, 0.05, seed=34)[0]
    rc = cli.main(["--device", "cpu", "--devices", "1", "-N",
                   "--profile-dir", str(tmp_path), q.decode(), t.decode()])
    assert rc == 0
    (path,) = tmp_path.glob("*.pt.trace.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "wfa"]
    assert {"call", "submit", "pack", "upload", "launch", "drain", "wait",
            "build"} <= {e["name"] for e in mine}
    (call,) = [e for e in mine if e["name"] == "call"]
    (mark,) = [e for e in events if e.get("name") == trace.MARK
               and e.get("ph") == "X"]
    # on the profiler's clock: the call span starts where its mark does
    assert abs(call["ts"] - mark["ts"]) < 1000
    assert call["tid"] == mark["tid"]
    assert "program spans" in capsys.readouterr().err
