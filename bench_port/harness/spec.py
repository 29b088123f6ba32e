"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each lives in a file of its own under ``bench_port/``: the configuration in
``configs/<file>`` as ``BENCHMARK.json`` gives it, the traffic in
``traffic/<traffic>.json``, the limits of the cell's correctness numbers in
``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``.  Adding a cell adds files; none is edited.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Any, Dict, List, Optional

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    reader: Optional[Any] = None  # the module of metrics/<name>.py


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_json(path: pathlib.Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _in_cell(metric: Dict[str, Any], cell: str, reported: set) -> bool:
    """A metric with ``workloads`` is in the cells it lists; an end-to-end
    one without is in every cell, a per-layer one in every cell that
    reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(name: str) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}; have {[w['name'] for w in bench['workloads']]}")
    config_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    end_to_end = [m for m in bench["end_to_end"] if _in_cell(m, name, set())]
    reported = {m["name"] for m in end_to_end}
    per_layer = [
        Metric(m["name"], m["unit"], load_reader(m["name"]))
        for m in bench["per_layer"]
        if _in_cell(m, name, reported)
    ]
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=load_json(ROOT / config_entry["file"]),
        traffic=load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=[Metric(m["name"], m["unit"]) for m in end_to_end],
        per_layer=per_layer,
    )


def scenarios() -> Dict[int, Dict[str, Any]]:
    data = load_json(BENCH_DIR / "traffic" / "scenarios.json")
    return {int(k): v for k, v in data.items()}
