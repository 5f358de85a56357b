"""What the benchmark's processes load, by whole top-level module names:
no ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX package, whose
name the port's begins with) in a run; nothing of the port either in the
reference."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]

_TOP = ("import json, sys; print(json.dumps(sorted({m.split('.')[0] for m "
        "in sys.modules})))")


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path[:0] = "
         f"[{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n{code}\n{_TOP}"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package():
    pytest.importorskip("torch")
    code = """
import time
from pathlib import Path
import portbench.run as run
from portbench import harness, spec
root = Path(run.ROOT)
bench = spec.load(root)
for w in bench["workloads"]:
    for trace in (False, True):
        for m in spec.cell(bench, root, w["name"], trace).metrics:
            spec.reader(m["name"])
cell = spec.cell(bench, root, bench["workloads"][0]["name"], False)
harness.run_cell(cell, 3, 0.1, False, device="cpu",
                 t_process=time.perf_counter(), log=lambda s: None,
                 overrides=dict(seeds_per_campaign=1, jobs_per_campaign=12,
                                warm_jobs=4))
"""
    top = _loaded(code)
    assert "repro_torch" in top and "portbench" in top
    assert not top & set(harness.BANNED), top & set(harness.BANNED)


def test_the_reference_loads_nothing_of_the_port():
    top = _loaded("import portbench.reference.model, "
                  "portbench.reference.prng, portbench.reference.sched, "
                  "portbench.correct, portbench.generator")
    assert not top & ({"repro_torch"} | set(harness.BANNED))


def test_banned_names_are_compared_whole(monkeypatch):
    before = set(harness.banned_modules())
    for name in ("repro_torch", "repro_torch.core", "reproducible",
                 "jaxlike"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(harness.banned_modules()) == before
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.banned_modules()


def test_run_refuses_without_a_card(tmp_path):
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "fcfs.npb-poisson", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_in_a_checkout_without_the_port(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files:
    no result, a non-zero exit."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "fcfs.npb-poisson", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
