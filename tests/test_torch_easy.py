"""Port parity: the batched EASY-backfilling core (``_easy_run`` behind
``Scheduler(queue="easy_backfill")``) against the reference's
``Scheduler(..., easy_eval="batched")`` on the same workloads and grids.

Tolerances (PERF.md "Parity bands"):

* exact — placements (``system``, ``tier``, ``nodes``), ``backfilled``,
  ``n_backfilled``, per-job ``start``/``finish``/``wait``/``energy``/
  ``runtime``, ``runs``, the learned ``C_tab``/``T_tab``, ``busy``,
  ``makespan``, ``max_wait``, ``idle_energy`` and every ``totals_only``
  total (Kahan sums).  The port fuses the multiply-adds the reference's
  compiled step fuses (``utils/fp.fma``): in the table update, ``old *
  n`` with several untiered lanes, ``truth * factor`` under DVFS tiers or
  with one lane (the ablation stream below); ``finish`` is a plain add in
  the EASY step.  The tables are exact, inside the reference's own
  batched-against-unrolled band (2.3e-10 / 7.6e-6);
* ``rtol=1e-6`` — the full path's reductions over jobs
  (``total_energy``, ``total_wait``, ``slowdown_sum``): the reference's
  compiled reduction adds in another order than ``torch.sum``.
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
from repro.core.policy import policy_names  # noqa: E402
from repro.data import scenarios as rs  # noqa: E402
from repro_torch.convert import (policy_from_reference,  # noqa: E402
                                 workload_from_reference)
from repro_torch.core import JSCC_SYSTEMS as T_SYSTEMS  # noqa: E402
from repro_torch.core import FaultConfig as TFault  # noqa: E402
from repro_torch.core import Scheduler as TScheduler  # noqa: E402
from repro_torch.core.result import CampaignResult  # noqa: E402
from repro_torch.data import scenarios as ts  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

EXACT = ("system", "tier", "nodes", "start", "finish", "wait", "energy",
         "runtime", "backfilled", "runs", "C_tab", "T_tab", "busy",
         "makespan", "max_wait", "idle_energy", "n_backfilled",
         "capped_delay", "peak_power")
REDUCED = ("total_energy", "total_wait", "slowdown_sum")
FAULTS = dict(straggler_prob=0.05, failure_prob=0.01)
#: every registry entry under EASY: its own queue, or the FCFS entries
#: moved onto it with ``apply_queue_spec``
EASY_ENTRIES = tuple(n for n in policy_names()
                     if r_make(n).queue in ("fcfs", "easy_backfill"))


def _easy(name, window=4, **params):
    pol = r_make(name, **params)
    return apply_queue_spec(pol, f"easy_backfill:window={window}")


def _run_both(w, policy, totals_only=False, faults=None, tw=None, **kw):
    """Run the reference (``easy_eval="batched"``) and the port (on the
    CPU) on the same inputs; ``tw`` is the port's own workload when it
    was built by the port rather than converted."""
    rf = tf = None
    if faults is not None:
        many = isinstance(faults, list)
        rf = [RFault(**f) for f in faults] if many else RFault(**faults)
        tf = [TFault(**f) for f in faults] if many else TFault(**faults)
    rr = RScheduler(policy, faults=rf, easy_eval="batched", **kw).run(
        w, totals_only=totals_only)
    tr = TScheduler(policy_from_reference(policy), faults=tf, device="cpu",
                    **kw).run(workload_from_reference(w) if tw is None
                              else tw, totals_only=totals_only)
    return rr, tr


def _assert_parity(rr, tr):
    """Equal field by field (the bands above); on a mismatch the message
    names the field and its first diverging index."""
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


@pytest.fixture(scope="module")
def stream80():
    out = rs.maintenance_windows(4, {0: [(20.0, 60.0)],
                                     2: [(5.0, 9.0), (40.0, 90.0)]})
    return rs.make_stream_workload(R_SYSTEMS, 80, "poisson", rate=0.5,
                                   seed=4, outage=out)


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("name", EASY_ENTRIES)
def test_registry_entry_matches(stream80, name, warm):
    """Every registry entry under EASY (window 4), warm and cold, with
    stragglers, failures and outage windows, over a 2-point K grid and
    two seeds."""
    pol = _easy(name, k=np.array([0.0, 0.2], np.float32))
    rr, tr = _run_both(stream80, pol, faults=FAULTS, seeds=[0, 1],
                       warm_start=warm)
    _assert_parity(rr, tr)


@pytest.mark.parametrize("totals_only", [False, True],
                         ids=["full", "totals"])
def test_fault_axis_and_outages_match(totals_only):
    """A fault axis (none / stragglers and failures), K grid and seeds
    over a stream whose windows cascade (a push landing in the next
    window), warm, window 8."""
    out = rs.maintenance_windows(4, {0: [(100.0, 400.0)],
                                     1: [(10.0, 30.0), (30.0, 200.0)],
                                     2: [(50.0, 80.0), (300.0, 900.0)]})
    w = rs.make_stream_workload(R_SYSTEMS, 120, "bursty", rate=0.5, seed=1,
                                outage=out)
    pol = _easy("paper", window=8, k=np.array([0.0, 0.1], np.float32))
    rr, tr = _run_both(w, pol, totals_only, faults=[{}, FAULTS],
                       seeds=[0, 1], warm_start=True)
    assert tr.axes == ("fault", "policy", "seed")
    _assert_parity(rr, tr)


@pytest.mark.parametrize("totals_only", [False, True],
                         ids=["full", "totals"])
@pytest.mark.parametrize("window", [1, 2])
def test_small_windows_with_simultaneous_arrivals(window, totals_only):
    """The NPB suite submitted eight times at t = 0: the window overflows
    at once, so the head is forced (FCFS fallback) until the drain."""
    w = r_npb(R_SYSTEMS, repeats=8)
    pol = _easy("easy_queue_aware", window=window,
                k=np.array([0.0, 0.3], np.float32))
    rr, tr = _run_both(w, pol, totals_only, faults=FAULTS, seeds=[3])
    _assert_parity(rr, tr)


@pytest.mark.parametrize("totals_only", [False, True],
                         ids=["full", "totals"])
def test_dvfs_tiers_and_per_job_k_match(totals_only):
    """DVFS tiers with a freq_weight grid, and per-job K overrides on
    every third job."""
    kj = np.full(100, np.nan, np.float32)
    kj[::3] = 0.25
    w = rs.make_stream_workload(R_SYSTEMS, 100, "poisson", rate=0.3, seed=2,
                                k_job=kj)
    pol = _easy("dvfs_queue_aware", window=6,
                k=np.array([0.0, 0.1, 0.2], np.float32),
                freq_weight=np.array([0.0, 1e-6, 5e-6], np.float32))
    rr, tr = _run_both(w, pol, totals_only, faults=FAULTS, seeds=[5])
    _assert_parity(rr, tr)
    if not totals_only:
        assert int(tr.tier.max()) > 0


def test_k_by_seed_grid_as_lanes():
    """The chip campaign's grid in small: K in {0, .05, .1, .2, .3} x
    seeds 0..3 = 20 lanes on a contended SWF-shaped stream, window 16,
    warm, stragglers and failures; the campaign axes index like the
    reference's."""
    cols = rs.synthetic_swf_arrays(60, seed=11)
    w = rs.workload_from_trace(rs.load_swf(rs.swf_lines(*cols)), R_SYSTEMS)
    pol = _easy("paper", window=16,
                k=np.array([0.0, 0.05, 0.1, 0.2, 0.3], np.float32))
    rr, tr = _run_both(w, pol, faults=FAULTS, seeds=[0, 1, 2, 3],
                       warm_start=True)
    assert isinstance(tr, CampaignResult) and tr.axes == ("policy", "seed")
    assert tr.system.shape == (5, 4, 60)
    _assert_parity(rr, tr)
    _assert_parity(rr.index(policy=2, seed=1), tr.index(policy=2, seed=1))
    np.testing.assert_allclose(tr.backfill_rate.numpy(),
                               np.asarray(rr.backfill_rate), rtol=1e-6)


def test_trace_replay_built_in_each_package():
    """The SWF fixture, loaded and calibrated by each package on its own,
    replayed under EASY with a K grid and two seeds."""
    path = "tests/data/jscc_sample.swf.gz"
    w = rs.workload_from_swf(path, R_SYSTEMS)
    tw = ts.workload_from_swf(path, T_SYSTEMS)
    pol = _easy("paper", window=16, k=np.array([0.0, 0.1, 0.3], np.float32))
    rr, tr = _run_both(w, pol, tw=tw, seeds=[0, 1], warm_start=True)
    _assert_parity(rr, tr)


def test_ablation_stream_easy_beats_fcfs():
    """The reference ablation's contended SWF stream (250 jobs, paper
    K = 0.1, warm, window 16): the port equals the reference, and EASY
    waits less than FCFS on it, the ablation's property."""
    w = rs.workload_from_trace(rs.load_swf(rs.swf_lines(
        *rs.synthetic_swf_arrays(250, 11))), R_SYSTEMS)
    rr, tr = _run_both(w, _easy("paper", window=16, k=0.1), warm_start=True)
    _assert_parity(rr, tr)
    fcfs = TScheduler("paper", device="cpu", warm_start=True).run(
        workload_from_reference(w))
    assert float(tr.total_wait) < float(fcfs.total_wait)
    assert int(tr.n_backfilled) > 0 and int(fcfs.n_backfilled) == 0


@pytest.mark.parametrize("name,totals_only,warm", [
    ("dvfs_paper", False, True),          # tiered, one lane
    ("random", False, False),
    ("easy_queue_aware", True, True),
])
def test_single_lane_runs_match(stream80, name, totals_only, warm):
    """One lane (no grid axis), where the reference's compiled table
    update fuses the other product: with faults and outage windows."""
    rr, tr = _run_both(stream80, _easy(name, window=8, k=0.15), totals_only,
                       faults=FAULTS, seeds=7, warm_start=warm)
    assert tr.axes == ()
    _assert_parity(rr, tr)


@pytest.mark.parametrize("placer", ["torch", "sort"])
def test_every_placer_mode_equals_the_default(stream80, placer):
    """Every kth-free mode of the port gives the default's results bit for
    bit (on the CPU the default is ``sort`` for the window and the
    recheck), and the reference with the same forced placer agrees."""
    pol = _easy("ucb", window=4, k=np.array([0.0, 0.2], np.float32))
    w = workload_from_reference(stream80)
    kw = dict(faults=TFault(**FAULTS), seeds=[0, 1], warm_start=True,
              device="cpu")
    tp = policy_from_reference(pol)
    base = TScheduler(tp, **kw).run(w)
    other = TScheduler(tp, placer=placer, **kw).run(w)
    for f in EXACT + REDUCED:
        a, b = getattr(base, f), getattr(other, f)
        assert torch.equal(a, b) or (a.isnan().all() and b.isnan().all()), f
    rr = RScheduler(pol, faults=RFault(**FAULTS), seeds=[0, 1],
                    warm_start=True, placer="sort").run(stream80)
    _assert_parity(rr, other)


def test_easy_options():
    """``easy_eval="unrolled"`` (item 15) runs and places as the batched
    step; EASY also runs on the event core (``engine="events"``, which
    reports the peak draw); a bad ``easy_eval`` is a ValueError."""
    with pytest.raises(ValueError, match="easy_eval"):
        TScheduler("easy_backfill", easy_eval="nope", device="cpu")
    w = workload_from_reference(r_npb(R_SYSTEMS))
    res = TScheduler("easy_backfill", engine="arrival", device="cpu").run(w)
    assert res.backfilled.shape == (5,) and res.n_backfilled.dim() == 0
    un = TScheduler("easy_backfill", engine="arrival", easy_eval="unrolled",
                    device="cpu").run(w)
    for f in ("system", "start", "backfilled", "runs", "n_backfilled"):
        assert torch.equal(getattr(un, f), getattr(res, f)), f
    ev = TScheduler("easy_backfill", engine="events", device="cpu").run(w)
    assert ev.backfilled.shape == (5,) and ev.n_backfilled.dim() == 0
    assert not bool(torch.isnan(ev.peak_power)) \
        and bool(torch.isnan(res.peak_power))
