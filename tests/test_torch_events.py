"""Port parity: the event-granular core (``engine="events"``: FCFS and
EASY on the event clock, failure re-queue, outages, DVFS tiers) against
the reference's ``Scheduler(..., engine="events")`` on the same streams.

Tolerances (PERF.md "Parity bands"):

* exact — placements (``system``, ``tier``, ``nodes``), ``backfilled``,
  per-job values, ``runs``, the learned ``C_tab``/``T_tab``, ``busy``,
  ``makespan``, ``max_wait``, ``idle_energy``, ``peak_power``,
  ``capped_delay`` and every ``totals_only`` total.  The port adds the
  cluster draw in the reference's order (``events.power_order``) and
  fuses the multiply-adds its compiled step fuses (``events._fusions``);
* ``rtol=1e-6`` — the full path's sums over jobs (``total_energy``,
  ``total_wait``, ``slowdown_sum``), added in another order.

Events FCFS also equals the port's own arrival FCFS bit for bit, the
reference's invariant (``tests/test_event_core.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import JSCC_SYSTEMS as R_SYSTEMS  # noqa: E402
from repro.core import FaultConfig as RFault  # noqa: E402
from repro.core import Scheduler as RScheduler  # noqa: E402
from repro.core.policy import apply_queue_spec  # noqa: E402
from repro.core.policy import make_policy as r_make  # noqa: E402
from repro.data import scenarios as rs  # noqa: E402
from repro_torch.convert import (policy_from_reference,  # noqa: E402
                                 workload_from_reference)
from repro_torch.core import FaultConfig as TFault  # noqa: E402
from repro_torch.core import Scheduler as TScheduler  # noqa: E402
from repro_torch.core import events  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

EXACT = ("system", "tier", "nodes", "start", "finish", "wait", "energy",
         "runtime", "backfilled", "runs", "C_tab", "T_tab", "busy",
         "makespan", "max_wait", "idle_energy", "n_backfilled",
         "capped_delay", "peak_power")
REDUCED = ("total_energy", "total_wait", "slowdown_sum")
#: the fields both FCFS cores report alike (the arrival core's power
#: fields are NaN / zero)
FCFS_FIELDS = ("system", "tier", "nodes", "start", "finish", "wait",
               "energy", "runtime", "runs", "C_tab", "T_tab", "busy",
               "makespan", "max_wait", "idle_energy", "n_backfilled") \
    + REDUCED
FAULTS = dict(straggler_prob=0.05, failure_prob=0.01)
#: faults whose factors round (2.5, 0.37): every fused site shows
HARD = dict(straggler_prob=0.5, straggler_factor=2.5, failure_prob=0.3,
            restart_overhead=0.37)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The event steps are many small ops: one intra-op thread keeps the
    test workers, which share the cores, from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(n=30, rate=0.8, kind="poisson", seed=3, **kw):
    return rs.make_stream_workload(R_SYSTEMS, n, arrival=kind, rate=rate,
                                   seed=seed, pred_noise=0.05, **kw)


def _faults(f):
    if f is None:
        return None, None
    if isinstance(f, list):
        return [RFault(**x) for x in f], [TFault(**x) for x in f]
    return RFault(**f), TFault(**f)


def _run_both(w, policy, totals_only=False, faults=None, **kw):
    rf, tf = _faults(faults)
    rr = RScheduler(policy, faults=rf, **kw).run(w, totals_only=totals_only)
    tr = TScheduler(policy_from_reference(policy), faults=tf, device="cpu",
                    **kw).run(workload_from_reference(w),
                              totals_only=totals_only)
    return rr, tr


def _assert_parity(rr, tr, fields=EXACT + REDUCED):
    """Equal field by field (the bands above); a mismatch names the field
    and its first diverging index."""
    assert tr.axes == rr.axes and tr.totals_only == rr.totals_only
    for f in fields:
        a, b = getattr(rr, f), getattr(tr, f)
        if a is None:
            assert b is None, f
            continue
        a, b = np.asarray(a), b.cpu().numpy()
        assert a.shape == b.shape, f
        if f in REDUCED and not rr.totals_only:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f)
        elif not np.array_equal(a, b, equal_nan=True):
            first = np.argwhere(a != b)[0].tolist()
            raise AssertionError(f"{f} differs first at {first}: "
                                 f"{a[tuple(first)]!r} != {b[tuple(first)]!r}")


@pytest.mark.parametrize("name", ["paper", "random", "queue_aware", "ucb"])
def test_event_fcfs_matches_and_equals_the_arrival_core(name):
    """Events FCFS over four registry entries (one lane, seed 7, warm):
    equal to the reference's event core, and bit for bit to the port's
    own arrival FCFS."""
    w = _stream()
    pol = r_make(name, k=0.1)
    rr, tr = _run_both(w, pol, warm_start=True, seeds=7, engine="events")
    _assert_parity(rr, tr)
    arr = TScheduler(policy_from_reference(pol), warm_start=True, seeds=7,
                     device="cpu").run(workload_from_reference(w))
    for f in FCFS_FIELDS:
        assert torch.equal(getattr(arr, f), getattr(tr, f)), f
    assert float(tr.peak_power) >= float(np.sum(w.idle_w * w.n_nodes))


@pytest.mark.parametrize("totals_only", [False, True],
                         ids=["full", "totals"])
def test_stragglers_and_outages_match(totals_only):
    """Straggler draws keyed by job id and outage pushes on the event
    clock, with a K grid and two seeds; ``totals_only`` keeps the full
    path's totals (the Kahan update runs only on placement steps)."""
    out = rs.maintenance_windows(4, {1: [(0.0, 300.0)], 2: [(50.0, 200.0)]})
    w = _stream(n=25, outage=out)
    pol = r_make("paper", k=np.array([0.0, 0.2], np.float32))
    rr, tr = _run_both(w, pol, totals_only,
                       faults=dict(straggler_prob=0.4, straggler_factor=2.5),
                       warm_start=True, seeds=[0, 1], engine="events")
    _assert_parity(rr, tr)


@pytest.mark.parametrize("seeds,faults", [
    ([0, 1], FAULTS),                 # EASY retries, a seed axis
    (4, None),                        # one lane, fault-free
], ids=["grid_retries", "one_lane"])
def test_event_easy_matches(seeds, faults):
    """Event-driven EASY (window 4 / 8): the head recheck over the trial
    rows; the finish time is a plain add there, unlike FCFS."""
    w = _stream(n=35, rate=1.0)
    window = 4 if faults else 8
    pol = apply_queue_spec(r_make("paper", k=np.array([0.0, 0.2], np.float32)
                                  if faults else 0.1),
                           f"easy_backfill:window={window}")
    rr, tr = _run_both(w, pol, faults=faults, warm_start=True, seeds=seeds,
                       engine="events")
    _assert_parity(rr, tr)
    assert int(np.asarray(tr.n_backfilled).sum()) > 0


@pytest.mark.parametrize("seeds", [3, [0, 1, 2]], ids=["one_lane", "seeds"])
def test_failure_requeue_matches(seeds):
    """Mid-job failures re-queue at their failure time (``retries``): a
    seed axis, and one lane, where the compiled step fuses the retry's
    runtime and ``old * n`` instead of ``truth * fac``."""
    w = _stream(n=20, rate=0.5, seed=9)
    rr, tr = _run_both(w, r_make("paper", k=0.1), faults=HARD,
                       warm_start=True, seeds=seeds, engine="events")
    _assert_parity(rr, tr)
    assert (tr.runtime > 0).all()


def test_dvfs_tiers_with_retries_match():
    """DVFS tiers on the event clock with a freq_weight grid and failure
    re-queue: the tier chosen per attempt, its realized (T, E) and the
    per-tier draw in the power sum."""
    w = rs.make_stream_workload(R_SYSTEMS, 40, "poisson", rate=1.0, seed=2)
    pol = r_make("dvfs_paper", k=np.array([0.1, 0.5, 0.1], np.float32),
                 freq_weight=np.array([0.0, 1e-6, 5e-6], np.float32))
    rr, tr = _run_both(w, pol, faults=HARD, warm_start=True, engine="events")
    _assert_parity(rr, tr)
    assert int(tr.tier.max()) > 0


def test_every_placer_mode_equals_the_default():
    """Every kth-free mode (``torch``, ``sort``) gives the default's
    results bit for bit on the event clock."""
    w = workload_from_reference(_stream(n=25))
    pol = policy_from_reference(apply_queue_spec(
        r_make("paper", k=np.array([0.0, 0.2], np.float32)),
        "easy_backfill:window=4"))
    kw = dict(faults=TFault(**FAULTS), warm_start=True, engine="events",
              device="cpu")
    base = TScheduler(pol, **kw).run(w)
    for placer in ("torch", "sort"):
        other = TScheduler(pol, placer=placer, **kw).run(w)
        for f in EXACT + REDUCED:
            assert torch.equal(getattr(base, f), getattr(other, f)), f


def test_fused_sites_are_load_bearing(monkeypatch):
    """With plain (twice-rounded) multiply-adds at the event step's fused
    sites, the port departs from the reference: at one lane with retries
    the retry's runtime and the tables, and over a grid the tables.  With
    the sites as ``_fusions`` reads them it does not (the other tests)."""
    w = _stream(n=40, rate=1.0)
    pol = r_make("paper", k=0.1)
    grid = r_make("paper", k=np.array([0.0, 0.1, 0.2, 0.3], np.float32))
    rr1, _ = _run_both(w, pol, faults=HARD, warm_start=True, engine="events")
    rr4, _ = _run_both(w, grid, faults=HARD, warm_start=True,
                       engine="events")
    plain = lambda a, b, c: a * b + c  # noqa: E731
    monkeypatch.setattr(events, "fma", plain)
    for rr, p in ((rr1, pol), (rr4, grid)):
        tr = TScheduler(policy_from_reference(p), faults=TFault(**HARD),
                        warm_start=True, engine="events", device="cpu").run(
            workload_from_reference(w))
        np.testing.assert_array_equal(tr.system.numpy(),
                                      np.asarray(rr.system))
        assert ((tr.C_tab.numpy() != np.asarray(rr.C_tab)).any()
                or (tr.T_tab.numpy() != np.asarray(rr.T_tab)).any())
    assert (tr.finish.numpy() != np.asarray(rr4.finish)).any()


def test_step_count_and_power_order():
    """The static step counts of the reference (``_stream_xs``), and the
    cluster-draw order: windows of 32 columns, padded evenly, row by row,
    at the JSCC width [4, 136]."""
    w = workload_from_reference(_stream(n=10))
    tp = policy_from_reference(r_make("paper"))
    cons = policy_from_reference(r_make("conservative"))
    assert events.step_count(w, tp, False) == 4 * 10 + 4
    assert events.step_count(w, tp, True) == 7 * 10 + 4
    assert events.step_count(w, cons, False) == 5 * 10 + 4
    assert events.step_count(w, cons, True) == 9 * 10 + 4
    idx, offsets, whole = events.power_order(4, 136, "cpu")
    assert offsets.tolist() == [0, 80, 208, 336, 464, 544]
    assert sorted(idx.tolist()) == list(range(544))
    assert idx[:3].tolist() == [0, 1, 2] and idx[20].tolist() == 136
    assert whole.tolist() == [0, 5]
