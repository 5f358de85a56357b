"""Port parity: the conservative-backfilling core (``queue=
"conservative"``: reservations at admission by the piecewise-capacity
earliest fit, realization after the kth-free rows recheck) against the
reference's on the same streams.

Tolerances as in ``tests/test_torch_events.py`` (PERF.md "Parity
bands"): every field exact, but the full path's sums over jobs
(``total_energy``, ``total_wait``, ``slowdown_sum``) within rtol 1e-6.
With failure re-queue the reference's compiled step fuses ``truth *
fac`` in the table update, else ``old * n`` (``events._fusions``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import JSCC_SYSTEMS as R_SYSTEMS  # noqa: E402
from repro.core import FaultConfig as RFault  # noqa: E402
from repro.core import Scheduler as RScheduler  # noqa: E402
from repro.core import make_npb_workload as r_npb  # noqa: E402
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


def _cons(name="paper", window=8, **params):
    return apply_queue_spec(r_make(name, **params),
                            f"conservative:window={window}")


def _run_both(w, policy, totals_only=False, faults=None, **kw):
    rf = tf = None
    if faults is not None:
        many = isinstance(faults, list)
        rf = [RFault(**f) for f in faults] if many else RFault(**faults)
        tf = [TFault(**f) for f in faults] if many else TFault(**faults)
    rr = RScheduler(policy, faults=rf, **kw).run(w, totals_only=totals_only)
    tr = TScheduler(policy_from_reference(policy), faults=tf, device="cpu",
                    **kw).run(workload_from_reference(w),
                              totals_only=totals_only)
    return rr, tr


def _assert_parity(rr, tr):
    assert tr.axes == rr.axes and tr.totals_only == rr.totals_only
    for f in EXACT + REDUCED:
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


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("window", [2, 8])
def test_windows_warm_and_cold_match(window, warm):
    """Windows 2 and 8 on a contended stream, warm and cold tables."""
    rr, tr = _run_both(_stream(n=40, rate=1.0), _cons(window=window, k=0.1),
                       warm_start=warm)
    _assert_parity(rr, tr)


@pytest.mark.parametrize("name", ["queue_aware", "fastest", "predictive"])
def test_selectors_compose(name):
    """The conservative queue under other selectors (bursty arrivals,
    window 6): selection happens at admission, with the tables then."""
    rr, tr = _run_both(_stream(n=30, kind="bursty", seed=5),
                       _cons(name, window=6, k=0.1), warm_start=True)
    _assert_parity(rr, tr)


@pytest.mark.parametrize("totals_only", [False, True],
                         ids=["full", "totals"])
def test_outages_and_a_fault_grid_match(totals_only):
    """Maintenance windows gate reserved starts (candidates pushed out of
    a window), under a fault axis (none / stragglers and failures, with
    re-queue) and two seeds; ``totals_only`` beside the full path."""
    out = rs.maintenance_windows(4, {1: [(0.0, 400.0)], 3: [(50.0, 250.0)]})
    w = rs.make_stream_workload(R_SYSTEMS, 35, arrival="poisson", rate=0.8,
                                seed=8, outage=out)
    rr, tr = _run_both(w, _cons(k=0.1), totals_only, faults=[{}, HARD],
                       seeds=[0, 1], warm_start=True)
    assert tr.axes == ("fault", "seed")
    _assert_parity(rr, tr)


@pytest.mark.parametrize("seeds", [0, [0, 1, 2]], ids=["one_lane", "seeds"])
def test_failure_requeue_matches(seeds):
    """A failing first attempt occupies its reserved span and is reserved
    afresh at its failure time; the retry never fails.  Every job still
    completes and a same-system retry's runtime is exactly (1 + 0.37) x
    its base (straggler 1 or 2.5 aside)."""
    w = _stream(n=20, rate=0.5, seed=9)
    rr, tr = _run_both(w, _cons(k=0.1), faults=HARD, seeds=seeds,
                       warm_start=True)
    _assert_parity(rr, tr)
    assert (tr.runtime > 0).all()


def test_dvfs_tiers_match():
    """DVFS tiers: one earliest fit per tier (a slower tier's longer
    window may fit another hole), failures re-queued."""
    w = rs.make_stream_workload(R_SYSTEMS, 40, "poisson", rate=1.0, seed=2)
    rr, tr = _run_both(w, _cons("dvfs_paper", k=0.1), faults=HARD,
                       warm_start=True)
    _assert_parity(rr, tr)


def test_fills_holes_without_delaying_reservations():
    """The reference's blocking case: ten LUs saturate KNL (the tenth
    reserves), the EPs jump into the hole under its reservation, and the
    held LU keeps its FCFS start exactly."""
    from dataclasses import replace
    order = ("LU",) * 10 + ("EP",) * 4
    w = r_npb(R_SYSTEMS, order=order, arrivals=np.zeros(len(order),
                                                        np.float32))
    w = replace(w, k_job=np.full(len(order), 5.0, np.float32))
    rr, tr = _run_both(w, _cons(window=16), warm_start=True)
    _assert_parity(rr, tr)
    fcfs = TScheduler("paper", warm_start=True, device="cpu").run(
        workload_from_reference(w))
    assert float(tr.start[9]) == float(fcfs.start[9])
    assert bool(tr.backfilled[10:].all())
    assert float(tr.total_wait) < float(fcfs.total_wait)


def test_conservative_beats_easy_on_a_contended_stream():
    """The reference's property: conservative's mean wait below EASY's
    and FCFS's on a contended stream (window 16)."""
    w = workload_from_reference(_stream(n=60, rate=1.5, seed=11))
    waits = {}
    for queue in ("fcfs", "easy_backfill:window=16",
                  "conservative:window=16"):
        r = TScheduler("paper", warm_start=True, queue=queue,
                       device="cpu").run(w)
        waits[queue.split(":")[0]] = float(r.total_wait)
    assert waits["conservative"] < waits["easy_backfill"]
    assert waits["conservative"] < waits["fcfs"]


def test_fused_table_update_is_load_bearing(monkeypatch):
    """With re-queue the table update fuses ``truth * fac``; fusing
    ``old * n`` instead (the no-retry site) departs from the reference
    on the tables, while no placement flips."""
    w = _stream(n=20, rate=0.5, seed=9)
    rr, _ = _run_both(w, _cons(k=0.1), faults=HARD, seeds=[0, 1, 2],
                      warm_start=True)
    real = events._table_update
    monkeypatch.setattr(events, "_table_update",
                        lambda *a: real(*a[:-1], not a[-1]))
    tr = TScheduler(policy_from_reference(_cons(k=0.1)),
                    faults=TFault(**HARD), seeds=[0, 1, 2], warm_start=True,
                    device="cpu").run(workload_from_reference(w))
    np.testing.assert_array_equal(tr.system.numpy(), np.asarray(rr.system))
    assert ((tr.C_tab.numpy() != np.asarray(rr.C_tab)).any()
            or (tr.T_tab.numpy() != np.asarray(rr.T_tab)).any())


def test_earliest_fit_sees_holes():
    """The piecewise-capacity earliest fit on a hand-built table: one
    system of 4 nodes, nodes 0-1 busy until 10, one reservation of 3
    nodes over [20, 30).  A 2-node job of 5 s fits at once (the hole
    under the reservation); a 2-node job of 25 s not before 30 (it would
    dip under the reservation at 20), a 3-node one not before 10; a
    1-node job of 25 s fits at once beside the reservation."""
    ctx = {"J": 5, "outage": None,
           "sys_col": torch.zeros((1, 1, 1, 1))}
    node_free = torch.tensor([[[10.0, 10.0, 0.0, 0.0]]])
    slots = torch.zeros((1, 2, len(events.CONS_COLS)))
    C = events.CONS_IX
    slots[0, 0, C["pend"]], slots[0, 0, C["sel"]] = 0, 0
    slots[0, 0, C["start"]], slots[0, 0, C["fin"]] = 20.0, 30.0
    slots[0, 0, C["need"]] = 3
    slots[0, 1, C["pend"]] = 5                                   # empty
    fit = lambda need, dur: float(events._earliest_fit(  # noqa: E731
        ctx, torch.tensor([[need]]), torch.tensor([0.0]),
        torch.tensor([[dur]]), node_free, slots))
    assert fit(2, 5.0) == 0.0
    assert fit(2, 25.0) == 30.0
    assert fit(3, 5.0) == 10.0
    assert fit(1, 25.0) == 0.0
