"""The cell ``exact.l1000-e20`` without the look for a card: the program's
plain versions on the CPU at the small mix of the other cells' tests, the
sound program correct, and a traced run reading the two metrics of the
tier ladder's retries and the aux's fill."""

import time
from pathlib import Path

from portbench import manifest, run

ROOT = Path(__file__).resolve().parents[2]
SPEC = manifest.load(ROOT)
# the SMALL mix of test_portbench_faults.py
SMALL = {"length": 240, "pairs_per_call": 16, "pool_calls": 2,
         "warmup_calls": 2, "trace_calls": 1, "check_per_call": 16,
         "check_retried_per_call": 2}
NAME = "exact.l1000-e20"


def _run(seconds, traced):
    cell = manifest.cell(SPEC, NAME, ROOT)
    cell.mix = dict(cell.mix, **SMALL)
    return run.run_cell(cell, 2**31 + 17, seconds, traced, device="cpu",
                        origin=time.perf_counter(), split={})["result"]


def test_the_cell_states_exact_alignment():
    cell = manifest.cell(SPEC, NAME, ROOT)
    assert cell.config["adaptive"] is None and cell.chips == 1
    assert run.pipeline_config(cell.config, "cpu").adaptive is None
    assert cell.mix["error_rate"] == 0.20 and cell.mix["length"] == 1000


def test_the_sound_program_is_correct():
    res = _run(3.0, False)
    assert res["correct"], res["check"]
    # a window makes at least one call, however long a call takes on a
    # loaded CPU
    assert res["attempted"] >= SMALL["pairs_per_call"]
    assert res["failed"] == 0
    assert set(res["metrics"]) == {"aln_per_s", "setup_s"}


def test_a_traced_run_reads_the_retries_and_the_aux_fill():
    res = _run(10.0, True)
    assert res["correct"], res["check"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert 0 <= got["retried_pct"] <= 100
    assert 0 < got["aux_fill_pct"] <= 100
    assert "pack_vector_pct" not in got  # its list names the long cells
