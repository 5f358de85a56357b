"""``BENCHMARK.json`` against the benchmark's contract, and every name in
it resolved to its files."""

import json
import re
from pathlib import Path

import pytest

from portbench import correct, spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names), group
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _line(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_end_to_end_metrics():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in CELLS:
        assert [m for m in BENCH["end_to_end"] if spec.reports(m, cell)
                and m["name"] != "setup_s"], cell


def test_per_layer_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            moved = next(x for x in BENCH["end_to_end"]
                         if x["name"] == m["moves"])
            assert spec.reports(moved, cell)
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline_share"):
            assert m["unit"] == "%"
    for cell in CELLS:
        assert [m for m in BENCH["per_layer"] if spec.reports(m, cell)]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    for trace in (False, True):
        c = spec.cell(BENCH, ROOT, cell, trace)
        assert c.chips == 1
        assert c.traffic["kind"] in ("npb_stream", "swf_synthetic")
        assert set(correct.NUMBERS) <= set(c.own["limits"])
        assert int(c.own["seeds_per_campaign"]) >= 1
        for key in ("warm_jobs", "trace_jobs"):
            assert 1 <= int(c.own[key]) <= c.config["jobs_per_campaign"]
        for m in c.metrics:
            assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert (ROOT / "portbench" / "metrics" / f"{metric}.py").exists()
    assert callable(spec.reader(metric))


def test_configs_list_what_they_change_from_the_source():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("portbench/")
        conf = json.loads(path.read_text())
        assert conf["name"] == c["name"]
        assert sorted(c["reduced"]) == sorted(conf["source_values"])
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    sources = [c["source"] for c in BENCH["configs"]]
    assert len(set(sources)) == len(sources)


def test_paths_hold_names_made_of_name_characters():
    for path in (ROOT / "portbench").rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or path.suffix == ".pyc":
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
