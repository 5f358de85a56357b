"""Port parity: the online scheduler service (``repro_torch.service``)
against the port's own batch run and the reference's batch and live runs.

Anchors:

* a live ``Dispatcher`` session fed a stream submit-before-drive-past
  equals the port's ``Scheduler(..., engine="events").run`` bit for bit
  on every ``FIELDS`` entry, and the reference's batch run bit for bit
  on every entry but the three sums over jobs, which the port's batch
  run itself holds to rtol 1e-6 (PERF.md "Parity bands": another
  summation order);
* on the small stream the reference's live session equals its batch run,
  and the port's live session equals it too, decisions included.  On the
  SWF stream at window 16 the reference's live session departs from its
  own batch run (ROADMAP "Reference caveats"), so the port is never held
  against it there;
* checkpoint round trips, what-if purity and projections, intake
  validation and the horizon gate behave as the reference's.

The failure re-queue sessions and the 250-job SWF stream are in
``test_torch_service_replay.py``, which shares this file's helpers.
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import FaultConfig as RFault  # noqa: E402
from repro.core import JSCC_SYSTEMS as R_SYSTEMS  # noqa: E402
from repro.core import Scheduler as RScheduler  # noqa: E402
from repro.core import make_npb_workload as r_npb  # noqa: E402
from repro.core import make_policy as r_make  # noqa: E402
from repro.service import Dispatcher as RDispatcher  # noqa: E402
from repro.service import whatif as r_whatif  # noqa: E402
from repro_torch.convert import (policy_from_reference,  # noqa: E402
                                 workload_from_reference)
from repro_torch.core import FaultConfig as TFault  # noqa: E402
from repro_torch.core import Scheduler as TScheduler  # noqa: E402
from repro_torch.core import events  # noqa: E402
from repro_torch.core.policy import make_policy  # noqa: E402
from repro_torch.service import Dispatcher, ServiceMetrics, whatif  # noqa: E402
from repro_torch.service.whatif import _rollout, rollout_length  # noqa: E402
from repro_torch.utils.tree import flatten_with_names  # noqa: E402

#: every total/per-job/table field a SimResult carries (the reference's
#: ``tests/test_service.py`` tuple)
FIELDS = ("system", "start", "finish", "wait", "energy", "runtime",
          "backfilled", "total_energy", "makespan", "total_wait",
          "slowdown_sum", "max_wait", "n_backfilled", "peak_power",
          "idle_energy", "capped_delay", "busy", "C_tab", "T_tab", "runs")
#: the sums over jobs: the port's batch run holds them to rtol 1e-6
REDUCED = ("total_energy", "total_wait", "slowdown_sum")
LATENCY = ("latency_us_last", "latency_us_total", "latency_us_max",
           "mean_latency_us")
#: faults whose first attempts fail often: the sessions re-queue
FAILS = dict(straggler_prob=0.2, failure_prob=0.4, restart_overhead=0.37)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The steps are many small ops: one intra-op thread keeps the test
    workers, which share the cores, from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_stream():
    return r_npb(R_SYSTEMS, order=("BT", "EP", "IS", "LU", "SP"), repeats=2,
                 arrivals=np.arange(10, dtype=np.float32) * 30.0)


def replay(w, disp):
    """The live protocol: submit each job before driving past its
    arrival, then drain."""
    for j in range(len(w.prog)):
        disp.drive(until=float(w.arrival[j]))
        disp.submit(int(w.prog[j]), float(w.arrival[j]))
    disp.drain()
    return disp


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_bit_identical(want, got, banded=()):
    """Every FIELDS entry byte for byte, but ``banded`` within rtol 1e-6;
    a mismatch names the field."""
    for f in FIELDS:
        a, b = _np(getattr(want, f)), _np(getattr(got, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if f in banded:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f)
        else:
            assert a.tobytes() == b.tobytes(), f"{f}: {a} != {b}"


def assert_decisions_match(disp, res):
    """Every decision the session emitted carries its job's final values
    in the result, once per job."""
    assert sorted(d["job"] for d in disp.decisions) == list(range(res.n_jobs))
    for d in disp.decisions:
        j = d["job"]
        for key, f in (("system", "system"), ("start", "start"),
                       ("finish", "finish"), ("wait", "wait"),
                       ("backfilled", "backfilled"), ("tier", "tier")):
            assert d[key] == getattr(res, f)[j].item(), (j, key)


def _sessions(w, pol, faults=None, seed=0, **kw):
    """The port's live session and batch run and the reference's batch
    run of one configuration, on the CPU."""
    tw, tp = workload_from_reference(w), policy_from_reference(pol)
    tf = None if faults is None else TFault(**faults)
    rf = None if faults is None else RFault(**faults)
    live = replay(tw, Dispatcher(tw, tp, fault=tf, seed=seed, device="cpu",
                                 **kw))
    batch = TScheduler(tp, faults=tf, seeds=seed, engine="events",
                       device="cpu", **kw).run(tw)
    ref = RScheduler(pol, faults=rf, seeds=seed, engine="events",
                     **kw).run(w)
    return live, batch, ref


# ------------------------------------------------------ live bit-identity

@pytest.mark.parametrize("queue", ["fcfs", "easy_backfill:window=4",
                                   "conservative:window=4"])
def test_live_replay_matches_batch_and_reference(queue):
    """Small stream: the port's live session equals the port's batch run
    and the reference's batch and live runs, decisions included."""
    w = small_stream()
    pol = r_make("paper", k=0.1)
    live, batch, ref = _sessions(w, pol, warm_start=True, queue=queue)
    res = live.result()
    assert_bit_identical(batch, res)
    assert_bit_identical(ref, res, banded=REDUCED)
    ref_live = replay(w, RDispatcher(w, pol, warm_start=True, queue=queue))
    assert_bit_identical(ref_live.result(), res, banded=REDUCED)
    assert live.decisions == ref_live.decisions
    assert len(live.decisions) == len(w.prog)


def test_live_power_cap_session():
    """A capped live session (EASY, window 4, 45 kW) defers exactly as the
    batch runs do."""
    w = small_stream()
    kw = dict(warm_start=True, queue="easy_backfill:window=4",
              power_cap=45e3)
    live, batch, ref = _sessions(w, r_make("paper", k=0.1), **kw)
    res = live.result()
    assert_bit_identical(batch, res)
    assert_bit_identical(ref, res, banded=REDUCED)
    assert float(res.peak_power) <= 45e3 * (1 + 1e-6)


def test_live_step_channels_only_with_live():
    """``live=False`` leaves the batch step's outputs as they were;
    ``live`` has no totals_only form."""
    pol = make_policy("paper", k=0.1)
    for make in (events.make_event_step, events.make_cons_step):
        with pytest.raises(ValueError, match="totals_only"):
            make(pol, totals_only=True, live=True)
    d = Dispatcher(workload_from_reference(small_stream()), pol,
                   device="cpu")
    d.submit(0, 0.0)
    _, out = events.make_event_step(pol)(d._ctx, d._carry, events.BIG)
    assert set(out) == {"j_add", "E", "j_fin", "sel_x", "vals"}
    _, out = d._step(d._ctx, d._carry, events.BIG)
    assert out["live"].shape == (1, len(events.LIVE_COLS))
    assert set(events.LIVE_COLS) <= set(out)


# ------------------------------------------------------------ checkpoint

def _feed(d, w, jobs):
    for j in jobs:
        d.drive(until=float(w.arrival[j]))
        d.submit(int(w.prog[j]), float(w.arrival[j]))


def test_checkpoint_roundtrip_bit_identical(tmp_path):
    """Save mid-stream, restore into a FRESH dispatcher, finish the
    stream: decisions and totals match the uninterrupted session."""
    w = workload_from_reference(small_stream())
    pol = make_policy("paper", k=0.1)

    def mk():
        return Dispatcher(w, pol, warm_start=True,
                          queue="easy_backfill:window=4",
                          checkpoint_dir=str(tmp_path), device="cpu")

    d1 = mk()
    _feed(d1, w, range(6))
    assert d1.save() == 0
    _feed(d1, w, range(6, 10))
    d1.drain()

    d2 = mk()
    assert d2.restore()
    assert d2.n_submitted == 6 and d2.now == float(d2._carry.now[0])
    _feed(d2, w, range(6, 10))
    d2.drain()

    assert d1.decisions == d2.decisions
    assert_bit_identical(d1.result(), d2.result())
    m1, m2 = d1.metrics.snapshot(), d2.metrics.snapshot()
    for key in LATENCY:
        m1.pop(key), m2.pop(key)
    assert m1 == m2


def test_restore_empty_dir_is_noop(tmp_path):
    d = Dispatcher(workload_from_reference(small_stream()),
                   make_policy("paper", k=0.1), checkpoint_dir=str(tmp_path),
                   device="cpu")
    assert not d.restore()
    assert d.n_submitted == 0
    with pytest.raises(RuntimeError, match="checkpoint_dir"):
        Dispatcher(workload_from_reference(small_stream()),
                   device="cpu").save()


# --------------------------------------------------------------- what-if

def _mid_session(capacity=12, **kw):
    w = workload_from_reference(small_stream())
    d = Dispatcher(w, make_policy("paper", k=0.1), warm_start=True,
                   capacity=capacity, device="cpu", **kw)
    _feed(d, w, range(6))
    return d


def test_whatif_does_not_mutate_live_carry():
    """The rollout is a pure fork: the live carry, job tensors, record
    and counters are unchanged by a query, leaf by leaf."""
    d = _mid_session(queue="easy_backfill:window=4")
    before = flatten_with_names(d.carry_snapshot())
    jobs = [d._ctx[k].clone() for k in ("prog", "arrival", "kjob", "K")]
    rec = [x.clone() for x in (d._rec.E, d._rec.sel_x, d._rec.vals)]
    n, now = d.n_submitted, d.now

    proj = whatif(d, prog=2)

    after = flatten_with_names(d.carry_snapshot())
    assert [name for name, _ in before] == [name for name, _ in after]
    for (name, a), (_, b) in zip(before, after):
        assert torch.equal(a, b), name
    for a, k in zip(jobs, ("prog", "arrival", "kjob", "K")):
        assert torch.equal(a.nan_to_num(-1.0), d._ctx[k].nan_to_num(-1.0)), k
    for a, b in zip(rec, (d._rec.E, d._rec.sel_x, d._rec.vals)):
        assert torch.equal(a, b)
    assert (d.n_submitted, d.now) == (n, now)
    assert proj["job"]["wait"] >= 0 and proj["makespan"] > 0


def test_whatif_projects_the_actual_submission():
    """Submitting the queried job realizes exactly the projection (no
    later arrivals intervene in this stream, so the rollout is exact)."""
    w = workload_from_reference(small_stream())
    d = replay(w, Dispatcher(w, make_policy("paper", k=0.1),
                             warm_start=True, capacity=12, device="cpu"))
    proj = whatif(d, prog=3)
    j = d.submit(3)
    d.drain()
    dec = [x for x in d.decisions if x["job"] == j]
    assert len(dec) == 1
    assert dec[0]["system"] == proj["job"]["system"]
    assert dec[0]["start"] == proj["job"]["start"]
    assert dec[0]["finish"] == proj["job"]["finish"]
    assert dec[0]["wait"] == proj["job"]["wait"]


@pytest.mark.parametrize("kw", [dict(queue="easy_backfill:window=4"),
                                dict(power_cap=60e3)])
def test_whatif_matches_reference(kw):
    """Mid-stream on the small stream: the port's projection equals the
    reference's ``whatif`` field for field (exact)."""
    w = small_stream()
    pol = r_make("paper", k=0.1)
    ref = RDispatcher(w, pol, warm_start=True, capacity=12, **kw)
    _feed(ref, w, range(6))
    d = _mid_session(**kw)
    want, got = r_whatif(ref, prog=2), whatif(d, prog=2)
    for f in ("system", "start", "wait", "finish", "backfilled"):
        assert got["job"][f] == want["job"][f], f
    for f in ("mean_wait", "makespan", "peak_power", "cap_headroom"):
        assert got[f] == want[f], f


def _assert_early_stop_equals_full(d):
    """The rollout from ``d``'s carry stopped at its first quiescent check
    (after every step, and every 8) against the full length: the same
    final carry and record, in fewer steps."""
    from repro_torch.core.events import _Record
    from repro_torch.utils.tree import map_with_names
    outs = []
    for every in (None, 1, 8):
        carry = map_with_names(lambda _, x: x.clone(), d._carry)
        rec = _Record(1, d.capacity, d.device)
        carry, steps = _rollout(d._step, d._ctx, carry, rec,
                                rollout_length(d), every)
        outs.append((carry, rec, steps))
    c2, r2, s2 = outs[0]
    assert s2 == rollout_length(d)
    for c1, r1, s1 in outs[1:]:
        assert s1 < s2
        for (name, a), (_, b) in zip(flatten_with_names(c1),
                                     flatten_with_names(c2)):
            assert torch.equal(a, b), name
        assert torch.equal(r1.sel_x[:, :-1], r2.sel_x[:, :-1])
        assert torch.equal(r1.vals[:, :-1], r2.vals[:, :-1])
        assert torch.equal(r1.E[:, :-1], r2.E[:, :-1])


def test_whatif_early_stop_equals_full_rollout():
    """Stopping at the first quiescent check gives the full-length
    rollout's record and final carry, and the same projection."""
    _assert_early_stop_equals_full(_mid_session(queue="conservative:window=4"))


@pytest.mark.parametrize("kw", [
    dict(queue="easy_backfill:window=4", power_cap=45e3),
    dict(queue="fcfs", fault=TFault(**FAILS), seed=3)])
def test_whatif_early_stop_capped_and_requeue(kw, monkeypatch):
    """The early stop under a power cap (deferred starts) and under
    failure re-queue (failed attempts pushed back): the full-length
    rollout's carry and record, and the same what-if answer."""
    d = _mid_session(**kw)
    _assert_early_stop_equals_full(d)
    early = whatif(d, prog=2)
    monkeypatch.setattr(sys.modules["repro_torch.service.whatif"],
                        "CHECK_EVERY", None)
    assert whatif(d, prog=2) == early


def test_whatif_reports_cap_headroom():
    w = workload_from_reference(small_stream())
    d = Dispatcher(w, make_policy("paper", k=0.1), warm_start=True,
                   power_cap=60e3, capacity=12, device="cpu")
    proj = whatif(d, prog=0, arrival=0.0)
    assert np.isfinite(proj["cap_headroom"])
    assert proj["peak_power"] + proj["cap_headroom"] == pytest.approx(60e3)
    assert whatif(_mid_session(), 0)["cap_headroom"] == float("inf")


# ------------------------------------------------------- intake / clock

def test_submit_validation():
    w = workload_from_reference(small_stream())
    d = Dispatcher(w, make_policy("paper", k=0.1), capacity=2, device="cpu")
    d.submit(0, 5.0)
    with pytest.raises(ValueError, match="catalog"):
        d.submit(99, 6.0)
    with pytest.raises(ValueError, match="arrival-ordered"):
        d.submit(1, 2.0)
    d.submit(1, 6.0)
    with pytest.raises(RuntimeError, match="full"):
        d.submit(0, 7.0)
    with pytest.raises(RuntimeError, match="session full"):
        whatif(d, 0)
    assert d.n_submitted == 2


def test_submit_in_the_past_rejected():
    w = workload_from_reference(small_stream())
    d = Dispatcher(w, make_policy("paper", k=0.1), warm_start=True,
                   device="cpu")
    d.submit(0, 50.0)
    d.drive(until=60.0)
    assert d.now >= 50.0
    with pytest.raises(ValueError, match="past"):
        d.submit(1, 10.0)
    with pytest.raises(ValueError, match="past"):
        whatif(d, 1, arrival=10.0)


def test_drive_horizon_gates_clock():
    """The clock never runs past the horizon — a live session cannot
    decide ahead of arrivals it has not been told about."""
    w = workload_from_reference(small_stream())
    d = Dispatcher(w, make_policy("paper", k=0.1), warm_start=True,
                   device="cpu")
    d.submit(0, 0.0)
    d.drive(until=10.0)
    assert d.now <= 10.0
    d.drive(until=1e4)
    assert d.now <= 1e4
    assert d.now == float(d._carry.now[0])


def test_grids_are_refused():
    w = workload_from_reference(small_stream())
    with pytest.raises(ValueError, match="one seed, not a grid"):
        Dispatcher.from_scheduler(TScheduler(seeds=[0, 1], device="cpu"), w)
    with pytest.raises(ValueError, match="one FaultConfig, not a fault"):
        Dispatcher.from_scheduler(TScheduler(
            faults=[TFault(), TFault(failure_prob=0.1)], device="cpu"), w)
    with pytest.raises(ValueError, match="leaf 'k' must be a scalar"):
        Dispatcher(w, make_policy("paper", k=np.array([0.0, 0.1],
                                                      np.float32)),
                   device="cpu")


def test_metrics_match_reference():
    """The streaming counters equal the reference's session's, except
    the wall-clock latency fields; a snapshot round-trips."""
    w = small_stream()
    pol = r_make("paper", k=0.1)
    ref = replay(w, RDispatcher(w, pol, warm_start=True))
    d = replay(workload_from_reference(w),
               Dispatcher(workload_from_reference(w),
                          policy_from_reference(pol), warm_start=True,
                          device="cpu"))
    want, got = ref.metrics.snapshot(), d.metrics.snapshot()
    for key in LATENCY:
        want.pop(key), got.pop(key)
    assert got == want
    m = d.metrics
    assert m.n_submitted == 10 and m.n_placed == 10 and m.n_finished == 10
    assert m.queue_depth == 0 and m.latency_us_total > 0
    assert ServiceMetrics.from_snapshot(m.snapshot()) == m
