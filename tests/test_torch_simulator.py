"""Port parity: the legacy simulator surface (``core/simulator.py``:
``SimConfig``, ``simulate_jax``, ``sweep_k``, ``run_campaign``), the
facade's deprecated ``core=`` spelling, and the two examples built on
them, against the reference's.

* the shims: every case of ``tests/test_engine_api.py:30-70, 189-232``
  (each legacy mode, the K grid, the fault x K x seed campaign, the
  queue and ``power_cap`` overrides), the port's shim against the
  reference's shim on the same stream: placements and per-job values
  exact, sums over jobs within rtol 1e-6 (PERF.md "Parity bands");
* ``SimConfig`` field for field, and its ``policy()``;
* ``examples/torch_quickstart.py`` prints ``examples/quickstart.py``'s
  lines; ``examples/torch_multi_cluster_campaign.py`` at ``--jobs 2
  --sim-jobs 200`` prints the reference's simulated lines (the K grid
  and the caps; timings dropped) and its executed half in the same
  format (its values follow the wall clock).
"""

import contextlib
import dataclasses
import importlib.util
import io
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.data.scenarios import make_stream_workload  # noqa: E402
from repro_torch.convert import (policy_from_reference,  # noqa: E402
                                 workload_from_reference)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERJOB = ("system", "start", "finish", "energy", "makespan", "peak_power",
          "capped_delay", "tier", "backfilled")
SUMS = ("total_energy", "total_wait")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def streams():
    """The reference test's stream, and its port copy."""
    w = make_stream_workload(R.JSCC_SYSTEMS, 30, arrival="poisson",
                             rate=0.1, seed=9, pred_noise=0.05)
    return w, workload_from_reference(w)


def _tconfig(scfg):
    return T.SimConfig(**dataclasses.asdict(scfg))


def _same(ref: dict, got: dict):
    for f in PERJOB:
        if f not in ref:
            assert f not in got, f
            continue
        a, b = np.asarray(ref[f]), got[f].numpy()
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=f)
    for f in SUMS:
        np.testing.assert_allclose(got[f].numpy(), np.asarray(ref[f]),
                                   rtol=1e-6, atol=0, err_msg=f)


@pytest.mark.parametrize("mode", R.MODES)
def test_simulate_jax_matches_per_mode(streams, mode):
    w, tw = streams
    scfg = R.SimConfig(mode=mode, k=0.1, warm_start=True, seed=5)
    _same(R.simulate_jax(w, scfg),
          T.simulate_jax(tw, _tconfig(scfg), device="cpu"))


def test_sweep_k_matches(streams):
    w, tw = streams
    ks = np.asarray([0.0, 0.1, 0.3], np.float32)
    scfg = R.SimConfig(mode="paper", warm_start=True)
    ref = R.sweep_k(w, scfg, ks)
    got = T.sweep_k(tw, _tconfig(scfg), ks, device="cpu")
    assert got["system"].shape == (3, 30)
    _same(ref, got)


def test_run_campaign_matches(streams):
    w, tw = streams
    ks, seeds = [0.0, 0.2], [0, 1, 2]
    scfg = R.SimConfig(mode="paper")
    ref = R.run_campaign(w, scfg, ks=ks, seeds=seeds,
                         faults=[R.FaultConfig(),
                                 R.FaultConfig(straggler_prob=0.3)])
    got = T.run_campaign(tw, _tconfig(scfg), ks=ks, seeds=seeds,
                         faults=[T.FaultConfig(),
                                 T.FaultConfig(straggler_prob=0.3)],
                         device="cpu")
    assert got["total_energy"].shape == (2, 2, 3)
    _same(ref, got)


@pytest.mark.parametrize("scfg", [
    R.SimConfig(mode="paper", warm_start=True, queue="easy_backfill",
                queue_window=4),
    R.SimConfig(mode="paper", warm_start=True, queue="conservative",
                queue_window=6, power_cap=47_000.0),
], ids=["easy_queue", "conservative_cap"])
def test_shims_honor_queue_and_power_cap(streams, scfg):
    """``sweep_k`` and ``run_campaign`` keep SimConfig's queue, window and
    cap (the shims must not drop the overrides)."""
    w, tw = streams
    ks = [0.0, 0.1]
    _same(R.sweep_k(w, scfg, ks),
          T.sweep_k(tw, _tconfig(scfg), ks, device="cpu"))
    _same(R.run_campaign(w, scfg, ks=ks, seeds=[0]),
          T.run_campaign(tw, _tconfig(scfg), ks=ks, seeds=[0],
                         device="cpu"))
    if scfg.power_cap < np.inf:
        peak = T.sweep_k(tw, _tconfig(scfg), ks, device="cpu")["peak_power"]
        assert float(peak.max()) <= scfg.power_cap * (1 + 1e-6)


def test_simconfig_field_for_field():
    rf = [(f.name, f.type, f.default) for f in dataclasses.fields(R.SimConfig)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(T.SimConfig)]
    assert tf == rf
    for kw in ({}, dict(mode="ucb", k=0.2), dict(queue="easy_backfill"),
               dict(queue="conservative", queue_window=6, power_cap=5e4),
               dict(mode="easy_queue_aware", queue_window=3)):
        assert policy_from_reference(R.SimConfig(**kw).policy()) == \
            T.SimConfig(**kw).policy()


def test_core_spelling_warns_and_conflicts():
    with pytest.warns(DeprecationWarning, match="deprecated"):
        s = T.Scheduler("paper", core="events", device="cpu")
    assert s.engine == "events" and s.core == "events"
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError, match="conflicts"):
            T.Scheduler("paper", core="arrival", engine="events",
                        device="cpu")
    with pytest.warns(DeprecationWarning):
        assert T.Scheduler("paper", core=None, device="cpu").core is None
    assert T.Scheduler("paper", device="cpu").core is None


def test_simulate_py_is_item_15(streams):
    with pytest.raises(NotImplementedError, match="item 15"):
        T.simulate_py(streams[1], T.SimConfig())


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue().splitlines()


def test_quickstart_prints_the_reference_lines():
    ref = _stdout(_example("quickstart").main)
    got = _stdout(_example("torch_quickstart").main, ["--device", "cpu"])
    assert len(ref) == 11 and got == ref


def test_multi_cluster_example_matches_the_reference(monkeypatch):
    argv = ["--jobs", "2", "--sim-jobs", "200"]
    monkeypatch.setattr("sys.argv", ["multi_cluster_campaign"] + argv)
    ref = _stdout(_example("multi_cluster_campaign").main)
    got = _stdout(_example("torch_multi_cluster_campaign").main,
                  argv + ["--device", "cpu"])
    assert len(got) == len(ref)
    simulated = re.compile(r"^  (K=|cap=)")
    sim_ref = [line for line in ref if simulated.match(line)]
    assert len(sim_ref) == 8
    assert [line for line in got if simulated.match(line)] == sim_ref
    # the executed half follows the wall clock: the same lines by format
    number = re.compile(r"[-+]?\d+(\.\d+)?")
    for a, b in zip(ref, got):
        if not simulated.match(a) and " in " not in a:
            assert number.sub("#", a).replace("jit", "run") == \
                number.sub("#", b), (a, b)
