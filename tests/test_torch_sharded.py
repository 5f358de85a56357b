"""Campaign scale, sharded: ``Scheduler(shards=...)`` splits the flat
(fault x policy x seed) lanes over devices (``engine._lane_split``): B
padded to a multiple of the device count by repeating the last lane,
each group of B_pad / n lanes run on its device, the results gathered and
the padding sliced off.

* the split over ``[cpu] * n`` (``launch.mesh.make_grid_devices``
  patched) for n = 1, 3, 4, 8 with B = 10 lanes (padding for 3, 4, 8)
  equals the unsharded run, composed with ``chunk`` too;
* on the CPU, ``shards="auto"`` and ``shards=1`` run on its one device
  and equal the unsharded run, ``shards=2`` raises the reference's
  ``ValueError``;
* one lane a group fuses as one lane does (``events._fusions``), so the
  port's four one-lane groups equal the reference's ``shards=4`` run on
  four host devices (a subprocess: the device count must be set before
  JAX starts) on EASY and on event FCFS with failure re-queue.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (JSCC_SYSTEMS, FaultConfig, Scheduler,  # noqa: E402
                              parse_policy_spec)
from repro_torch.data import make_stream_workload  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("system", "start", "finish", "energy", "backfilled", "runtime",
          "total_energy", "makespan", "total_wait", "slowdown_sum",
          "max_wait", "peak_power", "capped_delay", "busy", "idle_energy",
          "C_tab", "T_tab", "runs", "n_backfilled")
KS = np.linspace(0.0, 0.4, 5).astype(np.float32)     # 5 K x 2 seeds = 10
CASES = {
    "fcfs": dict(policy="ucb"),
    "easy": dict(policy="easy_backfill:window=6"),
    "events_requeue": dict(policy="paper", engine="events",
                           faults=FaultConfig(straggler_prob=0.2,
                                              failure_prob=0.3)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream():
    return make_stream_workload(JSCC_SYSTEMS, 40, arrival="poisson",
                                rate=0.5, seed=3, pred_noise=0.05)


def _sched(case, **kw):
    spec = dict(CASES[case])
    pol = parse_policy_spec(spec.pop("policy")).with_params(k=KS)
    return Scheduler(pol, warm_start=True, seeds=[0, 1], device="cpu",
                     **spec, **kw)


def _equal(a, b, totals_only=False):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if totals_only and x is None:
            assert y is None, f
            continue
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=f)


_BASE: dict = {}


@pytest.mark.parametrize("n", [1, 3, 4, 8])
@pytest.mark.parametrize("case", CASES)
def test_lane_split_equals_the_unsharded_run(stream, monkeypatch, case, n):
    """B = 10 lanes over n CPU "devices" (padded to 12 / 12 / 16 lanes
    for n = 3 / 4 / 8): every field equal to the unsharded run; the
    event case also chunked."""
    totals = case == "events_requeue"
    if case not in _BASE:
        _BASE[case] = _sched(case).run(stream, totals_only=totals)
    cpus = [torch.device("cpu")] * n
    monkeypatch.setattr(mesh, "make_grid_devices",
                        lambda shards, device=None: cpus[:int(shards)])
    chunk = 53 if totals else None
    got = _sched(case, shards=n, chunk=chunk).run(stream, totals_only=totals)
    assert got.axes == ("policy", "seed")
    assert got.total_energy.shape == (5, 2)
    _equal(_BASE[case], got, totals)


def test_shards_on_the_cpu(stream):
    """The CPU is one local device: "auto" and 1 run on it and equal the
    unsharded run; 2 raises the reference's message."""
    assert mesh.make_grid_devices("auto", "cpu") == [torch.device("cpu")]
    assert mesh.make_grid_devices(None, "cpu") == [torch.device("cpu")]
    base = _sched("fcfs").run(stream)
    for shards in ("auto", 1):
        _equal(base, _sched("fcfs", shards=shards).run(stream))
    with pytest.raises(ValueError,
                       match=r"shards=2 not in 1\.\.1 \(local devices\)"):
        _sched("fcfs", shards=2).run(stream)
    with pytest.raises(ValueError, match=r"shards=0 not in 1\.\.1"):
        mesh.make_grid_devices(0, "cpu")


_REFERENCE = """
import json, sys
import numpy as np
import jax
from repro.core import JSCC_SYSTEMS, FaultConfig, Scheduler, make_policy
from repro.core.policy import apply_queue_spec
from repro.data.scenarios import make_stream_workload

w = make_stream_workload(JSCC_SYSTEMS, 60, arrival="poisson", rate=0.8,
                         seed=3, pred_noise=0.05)
ks = np.array([0.0, 0.1], np.float32)              # 2 K x 2 seeds = 4
runs = {
    "easy": dict(policy=apply_queue_spec(make_policy("paper", k=ks),
                                         "easy_backfill:window=6")),
    "events_requeue": dict(policy=make_policy("paper", k=ks),
                           engine="events",
                           faults=FaultConfig(straggler_prob=0.2,
                                              failure_prob=0.3)),
}
out = {"devices": len(jax.devices())}
for name, kw in runs.items():
    res = Scheduler(kw.pop("policy"), warm_start=True, seeds=[0, 1],
                    shards=4, **kw).run(w).to_dict()
    out[name] = {f: np.asarray(v).tolist() for f, v in res.items()}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.mark.slow
def test_one_lane_a_group_matches_the_reference_shards(tmp_path,
                                                       monkeypatch):
    """Four lanes on four devices, one lane each, fuse as one lane does:
    the port's four one-lane groups equal the reference's ``shards=4``
    run field for field (EASY window 6; event FCFS with re-queue)."""
    from repro.core.policy import apply_queue_spec
    from repro.data.scenarios import make_stream_workload as r_stream
    from repro_torch.convert import (policy_from_reference,
                                     workload_from_reference)
    from repro.core import JSCC_SYSTEMS as R_SYSTEMS
    from repro.core import make_policy as r_make
    path = tmp_path / "ref.json"
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        + env.get("XLA_FLAGS", "")).strip()
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = json.loads(path.read_text())
    assert ref["devices"] == 4

    w = workload_from_reference(r_stream(R_SYSTEMS, 60, arrival="poisson",
                                         rate=0.8, seed=3, pred_noise=0.05))
    ks = np.array([0.0, 0.1], np.float32)
    cpus = [torch.device("cpu")] * 4
    monkeypatch.setattr(mesh, "make_grid_devices",
                        lambda shards, device=None: cpus[:int(shards)])
    runs = {
        "easy": dict(policy=apply_queue_spec(r_make("paper", k=ks),
                                             "easy_backfill:window=6")),
        "events_requeue": dict(policy=r_make("paper", k=ks),
                               engine="events",
                               faults=FaultConfig(straggler_prob=0.2,
                                                  failure_prob=0.3)),
    }
    for name, kw in runs.items():
        got = Scheduler(policy_from_reference(kw.pop("policy")),
                        warm_start=True, seeds=[0, 1], shards=4,
                        device="cpu", **kw).run(w).to_dict()
        for f in FIELDS:
            want = np.asarray(ref[name][f])
            have = got[f].numpy()
            if f in ("total_energy", "total_wait", "slowdown_sum"):
                np.testing.assert_allclose(have, want, rtol=1e-6,
                                           err_msg=f"{name}.{f}")
            else:
                np.testing.assert_array_equal(
                    have, want.astype(have.dtype), err_msg=f"{name}.{f}")
