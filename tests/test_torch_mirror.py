"""Port parity: the float64 differential mirror ``simulate_py``
(``core/simulator.py``) against the reference's, and the port's engine
against the port's mirror.

* the port's mirror equals the reference's bit for bit on every returned
  field (same float64 numpy arithmetic; the ``random`` objective's draw
  through ``utils.prng`` equals ``jax.random``'s), on the 25-job stream
  of ``tests/test_differential_sim.py:20-31`` over every registry entry
  warm and cold, EASY at windows 1 and 4, ``core="events"``,
  conservative with ``check_reservations=True``, a capped run, DVFS
  tiers, outage windows and SWF trace replay;
* the port's engine on the CPU (float32) equals the port's mirror within
  the reference's differential bands (``tests/test_differential_sim.py:
  34-46``): systems exact, energy / start / totals within rtol 1e-5
  (start atol 1e-3).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.data.scenarios import (load_swf, maintenance_windows,  # noqa: E402
                                  make_stream_workload, workload_from_trace)
from repro_torch.convert import workload_from_reference  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread, as the other port test files: the driver runs
    six workers on this machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream():
    """The reference test's 25 mixed jobs: staggered Poisson arrivals,
    per-job K overrides on every 5th job, noisy predictions."""
    rng = np.random.default_rng(1)
    order = tuple(rng.choice(["BT", "EP", "IS", "LU", "SP"], 25))
    arrivals = np.cumsum(rng.exponential(30.0, 25)).astype(np.float32)
    k_job = np.full(25, np.nan, np.float32)
    k_job[::5] = 0.3
    return R.make_npb_workload(R.JSCC_SYSTEMS, order=order,
                               arrivals=arrivals, k_job=k_job,
                               pred_noise=0.10)


def _outage_stream():
    outage = maintenance_windows(
        4, {2: [(0.0, 500.0), (800.0, 900.0)], 0: [(100.0, 300.0)]})
    return make_stream_workload(R.JSCC_SYSTEMS, 30, arrival="poisson",
                                rate=0.05, seed=5, outage=outage)


def _trace():
    swf = "\n".join(
        f"{i+1} {i*40} 0 {120 + 37*i % 900} {2 ** (2 + i % 6)} 100.0 0 "
        f"{2 ** (2 + i % 6)} 1000 0 1 1 1 1 1 1 -1 -1"
        for i in range(40)).splitlines()
    return workload_from_trace(load_swf(swf), R.JSCC_SYSTEMS)


WORKLOADS = {"stream": _stream, "outage": _outage_stream, "trace": _trace}

#: (id, workload, SimConfig fields, simulate_py keywords)
CASES = [
    *((f"{name}-{'warm' if warm else 'cold'}", "stream",
       dict(mode=name, k=0.1, warm_start=warm, seed=3), {})
      for name in R.policy_names() for warm in (True, False)),
    *((f"easy-w{win}", "stream",
       dict(mode="paper", k=0.1, warm_start=True, queue="easy_backfill",
            queue_window=win), {}) for win in (1, 4)),
    ("events", "stream", dict(mode="paper", k=0.1, core="events"), {}),
    ("events-easy", "stream", dict(mode="queue_aware", k=0.1, core="events",
                                   queue="easy_backfill", queue_window=4),
     {}),
    ("conservative", "stream", dict(mode="paper", k=0.1, warm_start=True,
                                    queue="conservative", queue_window=4),
     {"check_reservations": True}),
    ("capped", "stream", dict(mode="paper", k=0.1, warm_start=True,
                              power_cap=45_000.0), {}),
    ("dvfs-events", "stream", dict(mode="dvfs_paper", k=0.1, core="events",
                                   warm_start=True), {}),
    ("dvfs-easy", "stream", dict(mode="dvfs_paper", k=0.1, warm_start=True,
                                 queue="easy_backfill", queue_window=4), {}),
    *((f"outage-{name}", "outage", dict(mode=name, k=0.1), {})
      for name in ("paper", "first_free", "queue_aware", "predictive")),
    ("outage-easy", "outage", dict(mode="paper", k=0.1, warm_start=True,
                                   queue="easy_backfill", queue_window=4),
     {}),
    ("trace", "trace", dict(mode="paper", k=0.2), {}),
    ("trace-easy", "trace", dict(mode="paper", k=0.2, warm_start=True,
                                 queue="easy_backfill", queue_window=8), {}),
]
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def runs():
    """Each case's workloads (reference, port) and configs, built once;
    the port's mirror results are cached for the engine test."""
    ws = {name: make() for name, make in WORKLOADS.items()}
    return {"w": {n: (w, workload_from_reference(w)) for n, w in ws.items()},
            "mirror": {}}


def _port_mirror(runs, case):
    cid, wname, fields, kw = case
    if cid not in runs["mirror"]:
        tw = runs["w"][wname][1]
        runs["mirror"][cid] = T.simulate_py(tw, T.SimConfig(**fields), **kw)
    return runs["mirror"][cid]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mirror_equals_reference_mirror(runs, case):
    cid, wname, fields, kw = case
    rp = R.simulate_py(runs["w"][wname][0], R.SimConfig(**fields), **kw)
    tp = _port_mirror(runs, case)
    assert set(tp) == set(rp)
    for f in rp:
        a, b = np.asarray(rp[f]), np.asarray(tp[f])
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b, equal_nan=True), f


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_engine_within_differential_bands_of_mirror(runs, case):
    cid, wname, fields, kw = case
    tp = _port_mirror(runs, case)
    rj = T.simulate_jax(runs["w"][wname][1], T.SimConfig(**fields),
                        device="cpu")
    np.testing.assert_array_equal(rj["system"].numpy(), tp["system"])
    np.testing.assert_allclose(rj["energy"].numpy(), tp["energy"],
                               rtol=1e-5)
    np.testing.assert_allclose(rj["start"].numpy(), tp["start"], rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(float(rj["total_energy"]),
                               tp["total_energy"], rtol=1e-5)
    np.testing.assert_allclose(float(rj["makespan"]), tp["makespan"],
                               rtol=1e-5)


def test_mirror_reads_tensor_workloads_and_refuses_faults(runs):
    """Fields held as tensors read as the same host arrays; the mirror
    covers the deterministic path only, as the reference's."""
    tw = runs["w"]["stream"][1]
    as_tensors = dataclasses.replace(tw, **{
        f.name: torch.as_tensor(getattr(tw, f.name))
        for f in dataclasses.fields(tw)
        if isinstance(getattr(tw, f.name), np.ndarray)})
    cfg = T.SimConfig(mode="paper", k=0.1)
    a, b = T.simulate_py(tw, cfg), T.simulate_py(as_tensors, cfg)
    for f in a:
        assert np.array_equal(np.asarray(a[f]), np.asarray(b[f]),
                              equal_nan=True), f
    with pytest.raises(AssertionError, match="deterministic"):
        T.simulate_py(tw, T.SimConfig(failure_prob=0.1))
