"""Campaign scale, chunked: ``Scheduler(chunk=n)`` runs the steps in
windows of n steps, each with the per-job draws of only the jobs it can
read (``engine._window_ids``), and equals the monolithic run bit for bit
on every field of every core.

* the port's chunked run against its monolithic run: arrival FCFS,
  EASY (window 6), the event core (FCFS with failure re-queue) and
  conservative (window 6, failure re-queue), full path and
  ``totals_only``, chunks of 1, 37 and 41 steps and one at least as long
  as the run;
* the port's chunked totals against the reference's ``chunk=`` totals on
  the reference's own fixture (``tests/test_sharded_campaign.py``: 150
  Poisson jobs, rate 0.5, seed 3, ``pred_noise`` 0.05, seeds [0, 1, 2],
  warm), exact; FCFS and EASY full paths too;
* the reference's validation cases; a read outside a lane's window
  raises; a lane's pending jobs spread past any contiguous window.

The memory check (no J-sized tensor beside the lanes) is
``tests/test_torch_chunked_memory.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import JSCC_SYSTEMS as R_SYSTEMS  # noqa: E402
from repro.core import Scheduler as RScheduler  # noqa: E402
from repro.core import parse_policy_spec as r_spec  # noqa: E402
from repro.data import scenarios as rs  # noqa: E402
from repro_torch.convert import (policy_from_reference,  # noqa: E402
                                 workload_from_reference)
from repro_torch.core import JSCC_SYSTEMS, FaultConfig, Scheduler  # noqa: E402
from repro_torch.core import engine, events, parse_policy_spec  # noqa: E402
from repro_torch.data import make_stream_workload  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

TOTAL_FIELDS = ("total_energy", "makespan", "total_wait", "slowdown_sum",
                "max_wait", "peak_power", "capped_delay", "busy",
                "idle_energy", "C_tab", "T_tab", "runs", "n_backfilled")
PERJOB_FIELDS = ("system", "start", "finish", "energy", "backfilled",
                 "wait", "runtime", "nodes", "tier")

#: the four cores; the event and conservative runs re-queue failures
CORES = {
    "fcfs": dict(policy="paper"),
    "easy": dict(policy="easy_backfill:window=6"),
    "events": dict(policy="paper", engine="events"),
    "conservative": dict(policy="conservative:window=6"),
}
FAULTS = FaultConfig(straggler_prob=0.3, failure_prob=0.3)
J_SMALL = 24
#: a chunk at least as long as every core's run (9 J + 4 steps at most)
LONG = 9 * J_SMALL + 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small ops: one intra-op thread keeps the test workers, which
    share the cores, from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream():
    return make_stream_workload(JSCC_SYSTEMS, J_SMALL, arrival="poisson",
                                rate=0.8, seed=5, pred_noise=0.05)


def _port(core, chunk=None, **kw):
    spec = dict(CORES[core])
    return Scheduler(parse_policy_spec(spec.pop("policy")), warm_start=True,
                     seeds=[0, 1, 2], device="cpu", chunk=chunk, **spec,
                     **kw)


_MONO: dict = {}


def _mono(stream, core, totals_only):
    key = (core, totals_only)
    if key not in _MONO:
        _MONO[key] = _port(core, faults=FAULTS).run(
            stream, totals_only=totals_only).to_dict()
    return _MONO[key]


def _equal(a: dict, b: dict, fields):
    for f in fields:
        if a.get(f) is None:
            assert b.get(f) is None, f
            continue
        x, y = np.asarray(a[f]), b[f].cpu().numpy()
        assert x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("totals_only", [False, True],
                         ids=["full", "totals"])
@pytest.mark.parametrize("chunk", [1, 37, 41, LONG])
@pytest.mark.parametrize("core", CORES)
def test_chunked_equals_monolithic(stream, core, chunk, totals_only):
    """Chunk boundaries are invisible: the same steps on the same carry,
    every field equal to the monolithic run bit for bit."""
    mono = _mono(stream, core, totals_only)
    got = _port(core, chunk, faults=FAULTS).run(
        stream, totals_only=totals_only).to_dict()
    assert set(got) == set(mono)
    _equal({k: v.numpy() for k, v in mono.items()}, got,
           TOTAL_FIELDS + (() if totals_only else PERJOB_FIELDS))


#: options each core reads per job or per lane: the ``random``
#: objective's draws, per-job K, outages, DVFS tiers, caps, event EASY
OPTIONS = {
    "easy_random_kjob_outage": dict(policy="random", queue="easy_backfill:window=4"),
    "events_easy_capped": dict(policy="paper", queue="easy_backfill:window=4",
                               engine="events", power_cap=50_000.0),
    "events_random_requeue": dict(policy="random", engine="events",
                                  faults=FAULTS),
    "dvfs_fcfs": dict(policy="dvfs_paper"),
    "dvfs_conservative_capped": dict(policy="dvfs_paper",
                                     queue="conservative:window=4",
                                     power_cap=[55_000.0, np.inf]),
}


@pytest.fixture(scope="module")
def stream_options():
    """20 jobs with per-job K overrides on a third of them and a
    maintenance window on two systems."""
    import repro_torch.data.scenarios as ts
    k_job = np.where(np.arange(20) % 3 == 0, 0.3, np.nan).astype(np.float32)
    out = ts.maintenance_windows(4, {1: [(0.0, 60.0)], 3: [(20.0, 90.0)]})
    return make_stream_workload(JSCC_SYSTEMS, 20, arrival="poisson",
                                rate=0.8, seed=7, pred_noise=0.05,
                                outage=out, k_job=k_job)


@pytest.mark.parametrize("totals_only", [False, True],
                         ids=["full", "totals"])
@pytest.mark.parametrize("name", OPTIONS)
def test_chunked_equals_monolithic_with_options(stream_options, name,
                                                totals_only):
    """Every per-job and per-lane input through the chunk tables, at a
    7-step chunk: equal to the monolithic run on every field."""
    kw = dict(OPTIONS[name])
    pol = parse_policy_spec(kw.pop("policy"))

    def run(chunk):
        return Scheduler(pol, warm_start=False, seeds=[0, 1], device="cpu",
                         chunk=chunk, **kw).run(
            stream_options, totals_only=totals_only).to_dict()

    mono, got = run(None), run(7)
    assert set(got) == set(mono)
    _equal({k: v.numpy() for k, v in mono.items()}, got, tuple(mono))


@pytest.fixture(scope="module")
def stream_150():
    """The reference's own fixture of ``tests/test_sharded_campaign.py``."""
    return rs.make_stream_workload(R_SYSTEMS, 150, arrival="poisson",
                                   rate=0.5, seed=3, pred_noise=0.05)


@pytest.mark.parametrize("core,chunk,totals_only", [
    *((c, 37, True) for c in CORES),
    ("fcfs", 41, False), ("easy", 41, False)])
def test_chunked_matches_the_reference_chunked(stream_150, core, chunk,
                                               totals_only):
    """The port's chunked run equals the reference's ``chunk=`` run:
    totals exact; on the full path the per-job fields exact and the sums
    over jobs within rtol 1e-6 (PERF.md "Parity bands")."""
    spec = dict(CORES[core])
    pol = r_spec(spec.pop("policy"))
    ref = RScheduler(pol, warm_start=True, seeds=[0, 1, 2], chunk=chunk,
                     **spec).run(stream_150,
                                 totals_only=totals_only).to_dict()
    got = Scheduler(policy_from_reference(pol), warm_start=True,
                    seeds=[0, 1, 2], chunk=chunk, device="cpu", **spec).run(
        workload_from_reference(stream_150),
        totals_only=totals_only).to_dict()
    reduced = () if totals_only else ("total_energy", "total_wait",
                                      "slowdown_sum")
    exact = tuple(f for f in TOTAL_FIELDS if f not in reduced)
    _equal({k: np.asarray(v) for k, v in ref.items()}, got,
           exact + (() if totals_only else PERJOB_FIELDS))
    for f in reduced:
        np.testing.assert_allclose(got[f].numpy(), np.asarray(ref[f]),
                                   rtol=1e-6, atol=0, err_msg=f)


def test_chunk_validation():
    """The reference's cases (``tests/test_sharded_campaign.py:90-96``)."""
    with pytest.raises(ValueError, match="chunk must be a positive"):
        Scheduler("paper", chunk=0, device="cpu")
    with pytest.raises(ValueError, match="shards must be >= 1"):
        Scheduler("paper", shards=0, device="cpu")
    with pytest.raises(ValueError):
        Scheduler("paper", shards="many", device="cpu")


def test_a_read_outside_the_window_fails_loudly():
    """A job missing from a lane's window ids gets the out-of-range
    column, so the gather that reads with it raises instead of returning
    another job's draws (or zeros)."""
    ids = torch.tensor([[2, 5, 9, 9], [0, 1, 3, 7]])
    cols = engine._lookup(ids, torch.tensor([[5, 9], [0, 7]]))
    assert cols.tolist() == [[1, 2], [0, 3]]
    table = torch.arange(8.0).view(2, 4)
    for missing in ([[4, 9], [0, 7]], [[5, 9], [0, 8]]):
        with pytest.raises((IndexError, RuntimeError)):
            table.gather(1, engine._lookup(ids, torch.tensor(missing)))


@pytest.mark.parametrize("spec,kw", [
    ("easy_backfill:window=8", {}),
    ("paper", dict(engine="events", faults=FaultConfig(failure_prob=0.5)))],
    ids=["easy", "events_requeue"])
def test_pending_jobs_spread_past_a_contiguous_window(spec, kw):
    """A lane's pending jobs are not a range of the stream: a head waits
    while later jobs backfill, a failed job re-queues behind later ones.
    Seen at chunk 1, the spread exceeds W + 1 + chunk, so a window of the
    jobs from the lane's oldest pending one would miss some; the window
    ids are the pending set plus the next arrivals, and the run equals
    the monolithic one."""
    w = make_stream_workload(JSCC_SYSTEMS, 60, arrival="poisson", rate=2.0,
                             seed=2)
    spans = []
    orig = engine._window_ids

    def spy(pending, nxt, J):
        live = pending[pending < J]
        if live.numel():
            spans.append(int(live.max() - live.min()))
        return orig(pending, nxt, J)

    def run(chunk):
        return Scheduler(parse_policy_spec(spec), warm_start=True,
                         device="cpu", chunk=chunk, **kw).run(w)

    a = run(None)
    engine._window_ids = events._window_ids = spy
    try:
        b = run(1)
    finally:
        engine._window_ids = events._window_ids = orig
    assert max(spans) > 8 + 1 + 1, max(spans)
    for f in ("system", "start", "finish", "energy", "backfilled", "busy",
              "C_tab", "T_tab"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
