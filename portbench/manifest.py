"""Resolve a cell of ``BENCHMARK.json`` into its files, by name.

A configuration is the file its entry names; a traffic mix is
``portbench/traffic/<traffic>.json``; a per-layer metric is read by
``portbench/metrics/<name>.py``.  Adding a configuration, a mix or a
metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

from . import traffic as _traffic

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports


def load(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(spec: dict, name: str, root: Path) -> Cell:
    """The cell ``name`` of ``spec``; KeyError for a name it lacks."""
    work = {w["name"]: w for w in spec["workloads"]}[name]
    conf = {c["name"]: c for c in spec["configs"]}[work["config"]]
    with open(root / conf["file"]) as fh:
        config = json.load(fh)
    mix = load_mix(work["traffic"])
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if _reports(m, name) and m["moves"] in moved]
    return Cell(name, work["chips"], config, mix, e2e, per)


def load_mix(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as fh:
        mix = json.load(fh)
    missing = [k for k in _traffic.KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic {name}: no {', '.join(missing)}")
    return mix


def reader(metric: str) -> Optional[Callable[[dict], Optional[float]]]:
    """``read(ctx)`` of ``portbench/metrics/<metric>.py``, None where
    there is no such file."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        return None
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_all(metrics: List[dict], ctx: dict) -> Dict[str, dict]:
    """Each metric its reader finds something for, with its unit."""
    out = {}
    for m in metrics:
        fn = reader(m["name"])
        value = fn(ctx) if fn is not None else None
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
