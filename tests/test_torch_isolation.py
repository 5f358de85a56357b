"""The port stands alone: no module of ``repro_torch`` (and not
``chip_smoke.py``) imports JAX or the reference package, the entry points
never fall back to the CPU by themselves, and options outside the ported
slice are refused explicitly."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import (policy_from_reference,  # noqa: E402
                                 workload_from_reference)
from repro_torch.core import JSCC_SYSTEMS, Scheduler  # noqa: E402
from repro_torch.core import make_npb_workload, make_policy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_port_module_loads_no_jax_or_reference():
    code = ("import sys\n"
            f"for m in {list(_modules())!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", [*sorted(PKG.rglob("*.py")),
                                  ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scheduler().run(make_npb_workload(JSCC_SYSTEMS))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scheduler("paper", device="cuda")
    res = Scheduler(device="cpu").run(make_npb_workload(JSCC_SYSTEMS))
    assert res.total_energy.device.type == "cpu"


@pytest.mark.parametrize("kwargs,item", [
    ({"queue": "easy_backfill"}, "item 4"),
    ({"policy": "easy_queue_aware"}, "item 4"),
    ({"queue": "conservative:window=4"}, "item 6"),
    ({"policy": "conservative"}, "item 6"),
    ({"power_cap": 50_000.0}, "item 5"),
    ({"power_cap": [np.inf, 40_000.0]}, "item 5"),
    ({"engine": "events"}, "item 5"),
    ({"shards": "auto"}, "item 7"),
    ({"chunk": 1024}, "item 7"),
])
def test_unported_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        Scheduler(device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs", [{"placer": "pallas"},
                                    {"placer": "pallas_interpret"},
                                    {"engine": "bogus"}])
def test_bad_options_raise_value_error(kwargs):
    with pytest.raises(ValueError):
        Scheduler(device="cpu", **kwargs)


def test_reference_state_converts_duck_typed():
    """The converters take any object with the reference's fields, so the
    port never imports the reference to read its state."""
    w = make_npb_workload(JSCC_SYSTEMS)
    ns = SimpleNamespace(**{f.name: getattr(w, f.name)
                            for f in dataclasses.fields(w)})
    back = workload_from_reference(ns)
    for f in dataclasses.fields(w):
        a, b = getattr(w, f.name), getattr(back, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    pol = make_policy("ucb", k=np.array([0.0, 0.1], np.float32))
    ns = SimpleNamespace(**{f.name: getattr(pol, f.name)
                            for f in dataclasses.fields(pol)})
    out = policy_from_reference(ns)
    assert out.exploration == "optimistic_bound"
    np.testing.assert_array_equal(out.k, pol.k)


@pytest.mark.slow
def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA the chip script exits non-zero and prints no result,
    both in the repository and alone in an empty directory."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)], env=env,
                              cwd=script.parent, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
