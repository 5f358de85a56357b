"""Port parity: the online service's session pool
(``repro_torch.service.SessionPool``) against the reference's
``repro.service.SessionPool`` and against independent port
``Dispatcher`` sessions, on the same seeded inputs (the reference's
``tests/test_service_pool.py``, test for test).

Anchors:

* every lane of an N-session pool fed per-session streams equals an
  independent port ``Dispatcher`` with the same spec bit for bit
  (decisions and every ``FIELDS`` entry), and the reference's pool lane
  on the decisions and every entry but the three sums over jobs, which
  the port's batch run itself holds to rtol 1e-6 (PERF.md "Parity
  bands"): fcfs, EASY, conservative, capped, DVFS, and FCFS and
  conservative with failure re-queue, whose lanes take the one-lane
  fused sites (``events._fusions`` at ``site_lanes`` 1);
* the pool's step is built once, at construction, and a session with
  another static composition is refused;
* buffered intake realizes what immediate submission realizes and is
  validated at submit time; undriven lanes hold their carry and record
  bit for bit;
* pool checkpoints (blocking and through the writer) restore
  bit-identically, one session or all; ``whatif`` is pure and equals the
  independent session's and the reference's;
* ``AsyncWriter`` runs in order, drains on close and raises its worker's
  errors; the decision log carries every decision with its session.
"""

import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import FaultConfig as RFault  # noqa: E402
from repro.core import Scheduler as RScheduler  # noqa: E402
from repro.core import make_policy as r_make  # noqa: E402
from repro.service import SessionPool as RPool  # noqa: E402
from repro.service import whatif as r_whatif  # noqa: E402
from repro_torch.convert import (policy_from_reference,  # noqa: E402
                                 workload_from_reference)
from repro_torch.core import FaultConfig as TFault  # noqa: E402
from repro_torch.core import Scheduler as TScheduler  # noqa: E402
from repro_torch.core.policy import make_policy  # noqa: E402
from repro_torch.service import (AsyncWriter, Dispatcher,  # noqa: E402
                                 SessionPool, whatif)
from repro_torch.utils.tree import flatten_with_names  # noqa: E402

from test_torch_service import (FAILS, FIELDS, LATENCY,  # noqa: E402
                                REDUCED, _np, assert_bit_identical,
                                small_stream)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The steps are many small ops: one intra-op thread keeps the test
    workers, which share the cores, from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KINDS = ("fcfs", "easy", "conservative", "capped", "dvfs", "fcfs_requeue",
         "cons_requeue")
#: failure re-queue (stragglers at 1.5, restarts at 0.5)
REQUEUE = dict(straggler_prob=0.3, straggler_factor=1.5, failure_prob=0.4,
               restart_overhead=0.5)
#: where a faulted pool lane may differ from one session, as the
#: reference's does (``test_pool_fused_sites_follow_the_reference_pool``)
TABLES = ("C_tab", "T_tab")


def _policies(kind):
    """The reference's three-session policies of ``kind``: leaves differ,
    composition shared."""
    if kind in ("fcfs", "fcfs_requeue"):
        return [r_make("paper", k=k) for k in (0.05, 0.1, 0.2)]
    if kind == "easy":
        return [r_make("paper", k=k, queue="easy_backfill", window=4)
                for k in (0.05, 0.1, 0.2)]
    if kind in ("conservative", "cons_requeue"):
        return [r_make("paper", k=k, queue="conservative", window=4)
                for k in (0.05, 0.1, 0.2)]
    if kind == "capped":
        return [r_make("paper", k=0.1, power_cap=c)
                for c in (45000.0, 60000.0, 80000.0)]
    if kind == "dvfs":
        return [r_make("dvfs_paper", k=0.1, freq_tiers=(1.0, 0.8, 0.6),
                       freq_weight=fw) for fw in (0.0, 0.5, 1.0)]
    raise ValueError(kind)


def pool_scheds(kind, port=True, faults=None):
    """Three sessions of ``kind`` for the port (``port``) or the
    reference, seeds 0, 1, 2; the re-queue kinds with ``faults`` (default
    REQUEUE)."""
    if kind.endswith("_requeue"):
        faults = faults or REQUEUE
    out = []
    for i, pol in enumerate(_policies(kind)):
        if port:
            out.append(TScheduler(
                policy_from_reference(pol), warm_start=True, seeds=i,
                faults=None if faults is None else TFault(**faults),
                device="cpu"))
        else:
            out.append(RScheduler(
                pol, warm_start=True, seeds=i,
                faults=None if faults is None else RFault(**faults)))
    return out


def pool_replay(w, pool):
    """The live protocol, session-interleaved: every lane is driven to
    each arrival (the others hold their horizon) and submits the job."""
    for j in range(len(w.prog)):
        t = float(w.arrival[j])
        for i in range(pool.n):
            pool.drive(t, session=i)
            pool.submit(i, int(w.prog[j]), t)
    pool.drain()
    return pool


def independent_replay(w, scheds, capacity=None):
    ds = [Dispatcher.from_scheduler(s, w, capacity=capacity) for s in scheds]
    for d in ds:
        for j in range(len(w.prog)):
            d.drive(until=float(w.arrival[j]))
            d.submit(int(w.prog[j]), float(w.arrival[j]))
        d.drain()
    return ds


def _tw():
    return workload_from_reference(small_stream())


def _lane_state(pool, i):
    """Lane ``i``'s carry leaves and record rows, as copies (the record's
    sentinel column, which every step that places nothing writes, left
    out)."""
    leaves = [x[i].clone() for _, x in flatten_with_names(pool._carry)]
    rec = [x[i, :-1].clone() for x in (pool._rec.E, pool._rec.sel_x,
                                       pool._rec.vals)]
    return leaves + rec


def _assert_fields(want, got, skip=()):
    """Every FIELDS entry but ``skip`` byte for byte."""
    for f in FIELDS:
        if f not in skip:
            a, b = _np(getattr(want, f)), _np(getattr(got, f))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


def _assert_same_tensors(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x.nan_to_num(-1.0),
                                                  y.nan_to_num(-1.0))


# ------------------------------------------------- per-session identity

@pytest.mark.parametrize("kind", KINDS)
def test_pool_bit_identical_to_independent_sessions(kind):
    """Every lane of the pool realizes the decisions and the SimResult of
    the reference's pool lane (its sums over jobs within rtol 1e-6) and
    of an independent port session, bit for bit; with failure re-queue
    the learned tables only as the reference's pool lane (which departs
    there from its own independent sessions, as the port's does)."""
    w = small_stream()
    tw = workload_from_reference(w)
    inds = independent_replay(tw, pool_scheds(kind))
    pool = pool_replay(tw, SessionPool(pool_scheds(kind), tw))
    ref = pool_replay(w, RPool(pool_scheds(kind, port=False), w))
    for i, d in enumerate(inds):
        got = pool.result(i)
        assert pool.sessions[i].decisions == d.decisions
        _assert_fields(d.result(), got,
                       TABLES if kind.endswith("_requeue") else ())
        assert pool.sessions[i].decisions == ref.sessions[i].decisions
        assert_bit_identical(ref.result(i), got, banded=REDUCED)
        assert len(d.decisions) == len(tw.prog)
    assert pool._ctx["site_lanes"] is None and pool._ctx["B"] == pool.n
    assert pool.n_pool_steps > 0 and pool.mean_step_us > 0
    pool.close()
    ref.close()


def test_pool_fused_sites_follow_the_reference_pool():
    """With failure re-queue the reference's pool departs from its own
    independent sessions in the learned tables: its lanes fuse ``truth *
    fac`` and leave the retry's runtime unfused, where one FCFS session
    does the opposite (``events._fusions`` with ``site_lanes`` None).
    The port's pool follows the reference's pool bit for bit, its
    independent sessions the reference's, and the two differ only where
    the reference's do."""
    from repro.service import Dispatcher as RDispatcher
    w = small_stream()
    tw = workload_from_reference(w)
    pool = pool_replay(tw, SessionPool(pool_scheds("fcfs_requeue",
                                                   faults=FAILS), tw))
    ref = pool_replay(w, RPool(pool_scheds("fcfs_requeue", port=False,
                                           faults=FAILS), w))
    inds = independent_replay(tw, pool_scheds("fcfs_requeue", faults=FAILS))
    rinds = [RDispatcher.from_scheduler(s, w) for s in
             pool_scheds("fcfs_requeue", port=False, faults=FAILS)]
    apart = set()
    for i, (d, rd) in enumerate(zip(inds, rinds)):
        for j in range(len(w.prog)):
            rd.drive(until=float(w.arrival[j]))
            rd.submit(int(w.prog[j]), float(w.arrival[j]))
        rd.drain()
        got = pool.result(i)
        assert pool.sessions[i].decisions == ref.sessions[i].decisions
        assert_bit_identical(ref.result(i), got, banded=REDUCED)
        assert d.decisions == rd.decisions
        assert_bit_identical(rd.result(), d.result(), banded=REDUCED)
        for f in ("C_tab", "T_tab", "finish", "runtime", "system"):
            a, b = getattr(d.result(), f), getattr(got, f)
            r1, r2 = (np.asarray(getattr(x.result(), f)) for x in (rd,
                                                                   ref.sessions[i]))
            if not torch.equal(a, b):
                apart.add(f)
                assert r1.tobytes() != r2.tobytes(), f
    assert apart and apart <= {"C_tab", "T_tab"}
    pool.close()
    ref.close()


def test_pool_rejects_mixed_composition():
    w = _tw()
    with pytest.raises(ValueError, match="static"):
        SessionPool([TScheduler(make_policy("paper", k=0.1), device="cpu"),
                     TScheduler(make_policy("paper", k=0.1,
                                            queue="easy_backfill", window=4),
                                device="cpu")], w)
    with pytest.raises(ValueError, match="static"):
        SessionPool([TScheduler(make_policy("paper", k=0.1), device="cpu"),
                     TScheduler(make_policy("paper", k=0.1), device="cpu",
                                placer="sort")], w)
    with pytest.raises(ValueError, match="at least one"):
        SessionPool([], w)


# ------------------------------------------------------- batched intake

def test_batched_intake_matches_immediate_submission():
    """Many buffered submissions flush in one scatter a channel at the
    next drive and realize exactly what per-job submission realizes."""
    w = _tw()
    inds = independent_replay(w, pool_scheds("easy"))
    pool = SessionPool(pool_scheds("easy"), w)
    for i in range(pool.n):
        for j in range(len(w.prog)):
            assert pool.submit(i, int(w.prog[j]), float(w.arrival[j])) == j
    assert sum(len(b) for b in pool._buffers) == pool.n * len(w.prog)
    assert pool.sessions[0].n_submitted == 0      # nothing written yet
    pool.drain()
    for i, d in enumerate(inds):
        assert pool.sessions[i].decisions == d.decisions
        assert_bit_identical(d.result(), pool.result(i))
        assert torch.equal(pool.sessions[i]._ctx["K"], d._ctx["K"])
    pool.close()


def test_intake_validation_at_buffer_time():
    w = _tw()
    pool = SessionPool(pool_scheds("fcfs")[:2], w, capacity=3)
    pool.submit(0, 0, 0.0)
    pool.submit(0, 1, 5.0)
    with pytest.raises(ValueError, match="arrival-ordered"):
        pool.submit(0, 2, 1.0)          # behind the buffered tail
    pool.submit(0, 2, 9.0)
    with pytest.raises(RuntimeError, match="session full"):
        pool.submit(0, 3, 10.0)         # capacity counts the buffer
    with pytest.raises(ValueError, match="catalog"):
        pool.submit(1, 99, 0.0)
    pool.submit(1, 0, 9.0)
    pool.drive(4.0, session=1)          # written into the lane
    assert pool.sessions[1].n_submitted == 1 and not pool._buffers[1]
    with pytest.raises(ValueError, match="arrival-ordered"):
        pool.submit(1, 0, 8.0)          # behind the written tail (9.0)
    pool.close()


def test_undriven_lanes_hold_state():
    """Driving one session leaves the others' clocks, decisions, carry
    leaves and record rows untouched (their steps are no-ops)."""
    w = _tw()
    pool = SessionPool(pool_scheds("fcfs"), w)
    for i in range(pool.n):
        pool.submit(i, int(w.prog[0]), 0.0)
    held = [_lane_state(pool, i) for i in (1, 2)]
    pool.drive(300.0, session=0)
    assert pool.now(0) > 0.0
    assert pool.now(1) == 0.0 and pool.now(2) == 0.0
    assert not pool.sessions[1].decisions and not pool.sessions[2].decisions
    for i, before in zip((1, 2), held):
        _assert_same_tensors(before, _lane_state(pool, i))
    pool.close()


# ---------------------------------------------------- checkpoint/restore

def _feed(pool, w, lo, hi):
    for j in range(lo, hi):
        t = float(w.arrival[j])
        for i in range(pool.n):
            pool.drive(t, session=i)
            pool.submit(i, int(w.prog[j]), t)


@pytest.mark.parametrize("blocking", [True, False])
def test_pool_checkpoint_restore_bit_identical(tmp_path, blocking):
    """Kill a pool mid-stream, restore a fresh one from the namespaced
    checkpoints, replay the rest: decisions and totals equal the
    uninterrupted pool's bit for bit (blocking and writer save paths)."""
    w = _tw()
    half = len(w.prog) // 2
    ref = pool_replay(w, SessionPool(pool_scheds("easy"), w))

    ck = str(tmp_path / "ck")
    pool = SessionPool(pool_scheds("easy"), w, checkpoint_dir=ck)
    _feed(pool, w, 0, half)
    steps = pool.save(blocking=blocking)
    assert steps == [0] * pool.n
    pool.close()                          # drains the writer
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["s000", "s001", "s002"]
    del pool

    pool2 = SessionPool(pool_scheds("easy"), w, checkpoint_dir=ck)
    assert pool2.restore() is True
    assert [d.n_submitted for d in pool2.sessions] == [half] * pool2.n
    _feed(pool2, w, half, len(w.prog))
    pool2.drain()
    for i in range(ref.n):
        assert pool2.sessions[i].decisions == ref.sessions[i].decisions
        assert_bit_identical(ref.result(i), pool2.result(i))
        m1, m2 = ref.metrics(i), pool2.metrics(i)
        for key in LATENCY:
            m1.pop(key), m2.pop(key)
        assert m1 == m2
    pool2.close()
    ref.close()


def test_pool_restore_single_session(tmp_path):
    """One lane can be rolled back while the others keep their state bit
    for bit; the rolled-back lane then finishes as an uninterrupted
    session does."""
    w = _tw()
    ck = str(tmp_path / "ck")
    pool = SessionPool(pool_scheds("fcfs"), w, checkpoint_dir=ck)
    _feed(pool, w, 0, 3)
    pool.save()
    _feed(pool, w, 3, 6)
    pool.drain()                # restore refuses buffered submissions
    n_after = pool.sessions[2].n_submitted
    keep = [_lane_state(pool, i) for i in (0, 2)]
    assert pool.restore(session=1) is True
    assert pool.sessions[1].n_submitted == 3
    assert pool.sessions[2].n_submitted == n_after
    for i, before in zip((0, 2), keep):
        _assert_same_tensors(before, _lane_state(pool, i))
    # session 1 resumes from job 3 as an uninterrupted session would
    pool.submit(0, 0)
    with pytest.raises(RuntimeError, match="buffered"):
        pool.restore(session=0)
    for j in range(3, len(w.prog)):
        pool.drive(float(w.arrival[j]), session=1)
        pool.submit(1, int(w.prog[j]), float(w.arrival[j]))
    pool.drain(session=1)
    solo = independent_replay(w, pool_scheds("fcfs")[1:2])[0]
    assert pool.sessions[1].decisions == solo.decisions
    assert_bit_identical(solo.result(), pool.result(1))
    pool.close()


# --------------------------------------------------------------- whatif

def test_pool_whatif_pure_and_matches_member():
    """A what-if into one session leaves its lane and the pool unchanged
    and projects what the independent session (and the reference's)
    projects."""
    w = small_stream()
    tw = workload_from_reference(w)
    # capacity > stream length: the what-if needs a free slot
    inds = independent_replay(tw, pool_scheds("easy"), capacity=12)
    pool = pool_replay(tw, SessionPool(pool_scheds("easy"), tw, capacity=12))
    before = flatten_with_names(pool.sessions[1].carry_snapshot())
    lanes = [_lane_state(pool, i) for i in range(pool.n)]
    proj = pool.whatif(1, 2)
    after = flatten_with_names(pool.sessions[1].carry_snapshot())
    for (name, a), (_, b) in zip(before, after):
        assert torch.equal(a, b), name
    for i in range(pool.n):
        _assert_same_tensors(lanes[i], _lane_state(pool, i))
    assert proj == whatif(inds[1], 2)
    ref = RPool(pool_scheds("easy", port=False), w, capacity=12)
    pool_replay(w, ref)
    want = r_whatif(ref.sessions[1], 2)
    for f in ("system", "start", "wait", "finish", "backfilled"):
        assert proj["job"][f] == want["job"][f], f
    for f in ("mean_wait", "makespan", "peak_power", "cap_headroom"):
        assert proj[f] == want[f], f
    pool.close()
    ref.close()


# --------------------------------------------------------- async writer

def test_async_writer_orders_and_drains():
    out = []
    with AsyncWriter(maxsize=4) as wtr:
        for i in range(200):
            wtr.submit(out.append, i)   # backpressure past maxsize
    assert out == list(range(200))      # in order, fully drained


def test_async_writer_surfaces_worker_errors():
    wtr = AsyncWriter()

    def boom():
        raise RuntimeError("disk full")

    wtr.submit(boom)
    with pytest.raises(RuntimeError, match="disk full"):
        wtr.close()
    with pytest.raises(RuntimeError, match="closed"):
        wtr.submit(print)


def test_async_writer_flush_waits():
    out = []

    def slow(i):
        time.sleep(0.005)
        out.append(i)

    wtr = AsyncWriter()
    for i in range(10):
        wtr.submit(slow, i)
    wtr.flush()
    assert out == list(range(10))
    wtr.close()


# --------------------------------------------------------- decision log

def test_pool_decision_log(tmp_path):
    log = tmp_path / "decisions.jsonl"
    w = _tw()
    with SessionPool(pool_scheds("fcfs"), w, decision_log=str(log)) as pool:
        pool_replay(w, pool)
        per_session = {i: list(pool.sessions[i].decisions)
                       for i in range(pool.n)}
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert len(recs) == sum(len(d) for d in per_session.values())
    for i, decs in per_session.items():
        got = [{k: v for k, v in r.items() if k != "session"}
               for r in recs if r["session"] == i]
        assert got == decs


def test_pool_replicate_and_all_lane_drive():
    """``replicate`` (the CLI's ``--pool N``): N sessions of one spec fed
    through all-lane drives equal one independent session each."""
    w = _tw()
    sched = TScheduler(make_policy("paper", k=0.1), warm_start=True,
                       queue="easy_backfill:window=4", device="cpu")
    pool = SessionPool.replicate(sched, 2, w)
    for j in range(len(w.prog)):
        pool.drive(float(w.arrival[j]))
        for i in range(pool.n):
            pool.submit(i, int(w.prog[j]), float(w.arrival[j]))
    out = pool.drain()
    assert set(out) == {0, 1}
    solo = independent_replay(w, [sched])[0]
    for i in range(pool.n):
        assert pool.sessions[i].decisions == solo.decisions
        assert_bit_identical(solo.result(), pool.result(i))
    assert "SessionPool(n=2" in repr(pool)
    pool.close()
    pool.close()                         # idempotent
    assert np.all(pool._horizons >= 1e30)
