"""``BENCHMARK.json`` and the files each of its names resolves to.

A cell ``<config>.<mix>`` of ``workloads`` finds its configuration at
``portbench/configs/<config>.json`` (the entry's ``file``), its traffic
mix at ``portbench/traffic/<mix>.json``, its own sizes and limits at
``portbench/cells/<cell>.json``, and every metric its reader at
``portbench/metrics/<metric>.py``.  Adding a cell, a mix or a metric adds
files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    own: dict            # cells/<cell>.json: seeds per campaign, limits
    metrics: list        # BENCHMARK.json metric entries this cell reports


def load(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: every cell, unless the metric
    lists its cells."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, root: Path, name: str, trace: bool) -> Cell:
    """Cell ``name`` with its files read, and the metrics it reports in a
    run with ``trace`` (per-layer) or without (end to end)."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {known}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    metrics = [m for m in bench["per_layer" if trace else "end_to_end"]
               if reports(m, name)]
    return Cell(name=name, chips=int(entry["chips"]),
                config=_json(root / conf["file"]),
                traffic=_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                own=_json(HERE / "cells" / f"{name}.json"),
                metrics=metrics)


def reader(metric: str):
    """The ``read(ctx)`` function of metric ``metric``'s reader file."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
