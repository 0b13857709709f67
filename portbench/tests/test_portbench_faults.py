"""A whole run without the look for a card: the program's plain versions on
the CPU at a small size, its timed path broken underneath in each way a
cell can break, and ``correct`` coming out false each time (true for the
sound program)."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import manifest, run

ROOT = Path(__file__).resolve().parents[2]
SPEC = manifest.load(ROOT)
SMALL = {"length": 240, "pairs_per_call": 16, "pool_calls": 2,
         "warmup_calls": 2, "trace_calls": 1, "check_per_call": 16,
         "check_retried_per_call": 2}


def _run(name, seconds=1.0, traced=False, n_devices=None):
    cell = manifest.cell(SPEC, name, ROOT)
    cell.mix = dict(cell.mix, **SMALL)
    return run.run_cell(cell, 2**31 + 11, seconds, traced, device="cpu",
                        origin=time.perf_counter(), split={},
                        n_devices=n_devices)["result"]


@pytest.mark.parametrize("name", ["global.l50000-e05",
                                  "global.l50000-e05.x4"])
def test_the_sound_program_is_correct(name):
    res = _run(name, n_devices=2 if name.endswith("x4") else None)
    assert res["correct"], res["check"]
    assert res["attempted"] >= 32 and res["failed"] == 0
    assert set(res["metrics"]) >= {"aln_per_s", "setup_s", "call_p95_ms"}
    assert list(res)[-1] == "check"


def test_a_traced_run_reads_the_per_layer_metrics():
    res = _run("global.l50000-e05", seconds=3.0, traced=True)
    assert res["correct"]
    assert {"gc_pause_pct", "host_submit_ms_per_kpair",
            "host_finish_ms_per_kpair"} <= set(res["metrics"])
    assert "aln_per_s" not in res["metrics"]
    assert res["breakdown"]["idle_gaps"]


def test_a_state_returned_unchanged(monkeypatch):
    """Every call hands back the results of the first."""
    from wfa_tpu_torch.pipeline import AlignmentPipeline

    orig, first = AlignmentPipeline.align_all, []

    def stale(self, pairs):
        out = orig(self, pairs)
        first[:] = first or [out]
        return first[0]

    monkeypatch.setattr(AlignmentPipeline, "align_all", stale)
    assert not _run("global.l50000-e05")["correct"]


def test_half_of_the_batch_left_out(monkeypatch):
    from wfa_tpu_torch.engine import BatchAligner

    orig = BatchAligner.finish_tokens

    def half(self, h, fallback=True):
        out = orig(self, h, fallback)
        return out[:len(out) // 2]

    monkeypatch.setattr(BatchAligner, "finish_tokens", half)
    res = _run("global.l50000-e05")
    assert not res["correct"]
    assert res["check"]["missing_results"]["value"] > 0


def test_the_exchange_between_cards_left_out(monkeypatch):
    """A mesh's batch takes its first shard's results for every shard."""
    from wfa_tpu_torch.engine import BatchAligner

    orig = BatchAligner.finish_tokens

    def no_exchange(self, h, fallback=True):
        if h.parts is None:
            return orig(self, h, fallback)
        eng, part = h.parts[0]
        first = eng.finish_tokens(part, fallback)
        return (first * len(h.parts))[:len(h.pairs)]

    monkeypatch.setattr(BatchAligner, "finish_tokens", no_exchange)
    assert not _run("global.l50000-e05.x4", n_devices=2)["correct"]
    monkeypatch.undo()
    assert _run("global.l50000-e05.x4", n_devices=2)["correct"]


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from wfa_tpu_torch.engine import DeviceResult

    orig = DeviceResult.from_device.__func__

    def altered(cls, ga, score, tokens):
        return orig(cls, ga, score + 2, tokens)

    monkeypatch.setattr(DeviceResult, "from_device", classmethod(altered))
    res = _run("global.l50000-e05")
    assert not res["correct"]
    assert res["check"]["mismatched_scores"]["value"] > 0


def test_a_token_altered_where_it_is_produced(monkeypatch):
    """Every op the backtrace emits into its token buffer one base
    longer."""
    from wfa_tpu_torch import device_backtrace as db

    orig = db.device_backtrace

    def bumped(*args, **kwargs):
        out = orig(*args, **kwargs)
        buf = out[1]
        buf[buf != 0] += 1
        return out

    bumped.launches = orig.launches
    monkeypatch.setattr(db, "device_backtrace", bumped)
    assert not _run("global.l50000-e05")["correct"]


@pytest.mark.cuda
def test_a_cell_on_the_card(tmp_path):
    """One short run of each one-card cell on the card (skips without
    one): exit 0 and a correct result line."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for w in SPEC["workloads"]:
        if w["chips"] > torch.cuda.device_count():
            continue
        proc = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload", w["name"],
             "--seed", "2147483999", "--seconds", "3", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=900,
            env=dict(os.environ))
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert json.loads(proc.stdout.splitlines()[-1])["correct"]
