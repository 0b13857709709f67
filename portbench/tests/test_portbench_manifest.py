"""The benchmark's manifest and files: every name resolves, every name and
unit keeps to the contract's characters, and nothing imports JAX, the JAX
package or (in the reference) the port."""

import ast
import json
import re
from pathlib import Path

import pytest

from portbench import manifest, traffic

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


@pytest.mark.parametrize("work", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves_by_name(work):
    cell = manifest.cell(SPEC, work["name"], ROOT)
    assert cell.config["name"] == work["config"]
    assert set(traffic.KEYS) <= set(cell.mix)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert manifest.reader(m["name"]) is not None, m["name"]


def test_names_units_and_lines_keep_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [w["config"] for w in SPEC["workloads"]]
    names += [w["traffic"] for w in SPEC["workloads"]]
    names += [m["name"] for m in METRICS]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    lines = [c[k] for c in SPEC["configs"] for k in ("why", "source")]
    lines += [w["why"] for w in SPEC["workloads"]]
    lines += [m["layer"] for m in SPEC["per_layer"]] + SPEC["command"]
    assert all(LINE.match(s) for s in lines)
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        assert len({g["name"] for g in group}) == len(group)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_metrics_keys_and_bounds():
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for m in METRICS:
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_config_files_lie_under_paths_and_state_their_cut():
    for c in SPEC["configs"]:
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert body["placement"] == "none"  # where the system puts it


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "wfa_tpu"}
    if "reference" in path.parts:
        assert "wfa_tpu_torch" not in tops
