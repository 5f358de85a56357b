"""Port parity: ``Scheduler.run`` of the arrival-FCFS engine
(repro_torch.core.engine) against the reference's, on the same workloads
and policy grids.

Tolerances (PERF.md "Parity bands"):

* exact — placements (``system``, ``tier``, ``nodes``), per-job
  ``start``/``finish``/``wait``/``energy``/``runtime``, ``runs``, the
  learned ``C_tab``/``T_tab``, ``busy``, ``makespan``, ``max_wait``,
  ``idle_energy`` and every ``totals_only`` total (Kahan sums).  The port
  fuses the multiply-adds the reference's compiled step fuses
  (``utils/fp.fma``), so the arithmetic is the same op for op;
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
from repro.core.policy import make_policy as r_make  # noqa: E402
from repro.core.policy import policy_names  # noqa: E402
from repro.data.scenarios import maintenance_windows  # noqa: E402
from repro.data.scenarios import make_stream_workload as r_stream  # noqa: E402
from repro_torch.convert import (policy_from_reference,  # noqa: E402
                                 workload_from_reference)
from repro_torch.core import FaultConfig as TFault  # noqa: E402
from repro_torch.core import Scheduler as TScheduler  # noqa: E402
from repro_torch.core.result import CampaignResult, SimResult  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

EXACT = ("system", "tier", "nodes", "start", "finish", "wait", "energy",
         "runtime", "backfilled", "runs", "C_tab", "T_tab", "busy",
         "makespan", "max_wait", "idle_energy", "n_backfilled",
         "capped_delay", "peak_power")
REDUCED = ("total_energy", "total_wait", "slowdown_sum")
FCFS_ENTRIES = tuple(n for n in policy_names()
                     if r_make(n).queue == "fcfs")
FAULTS = dict(straggler_prob=0.05, failure_prob=0.01)


def _run_both(w, policy, totals_only=False, faults=None, **kw):
    """Run the reference and the port (on the CPU) on the same inputs."""
    rp = r_make(policy) if isinstance(policy, str) else policy
    rf = tf = None
    if faults is not None:
        many = isinstance(faults, list)
        rf = [RFault(**f) for f in faults] if many else RFault(**faults)
        tf = [TFault(**f) for f in faults] if many else TFault(**faults)
    rr = RScheduler(rp, faults=rf, **kw).run(w, totals_only=totals_only)
    tr = TScheduler(policy_from_reference(rp), faults=tf, device="cpu",
                    **kw).run(workload_from_reference(w),
                              totals_only=totals_only)
    return rr, tr


def _assert_parity(rr, tr):
    assert tr.axes == rr.axes and tr.totals_only == rr.totals_only
    kahan = rr.totals_only
    for f in EXACT + REDUCED:
        a, b = getattr(rr, f), getattr(tr, f)
        if a is None:
            assert b is None, f
            continue
        a, b = np.asarray(a), b.cpu().numpy()
        assert a.shape == b.shape, f
        if f in REDUCED and not kahan:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.fixture(scope="module")
def stream300():
    return r_stream(R_SYSTEMS, 300, "poisson", rate=0.5, seed=0)


@pytest.fixture(scope="module")
def stream60():
    out = maintenance_windows(4, {0: [(20.0, 60.0)], 2: [(5.0, 9.0),
                                                         (40.0, 90.0)]})
    return r_stream(R_SYSTEMS, 60, "poisson", rate=0.5, seed=4, outage=out)


def test_paper_k_sweep_matches_and_claims_hold():
    """The paper's experiment (NPB suite, warm start, K sweep) through the
    port: placements exact, and the assertions of test_paper_claims.py
    hold on the port's numbers."""
    w = r_npb(R_SYSTEMS)
    ks = np.array([0.0, 0.05, 0.10, 0.20, 0.85], np.float32)
    rr, tr = _run_both(w, r_make("paper", k=ks), warm_start=True)
    _assert_parity(rr, tr)
    E = tr.total_energy.numpy().astype(np.float64)
    M = tr.makespan.numpy().astype(np.float64)
    dE, dM = (E - E[0]) / E[0], (M - M[0]) / M[0]
    assert dE[1:4].min() <= -0.12 and dM[1:4].max() <= 0.10
    assert (E[0] - E[2]) / E[0] >= 0.10
    sel = tr.system.numpy()
    names = [w.programs[p] for p in w.prog]
    switched = {names[j]: sel[0, j] != sel[1, j] for j in range(len(names))}
    assert not switched["LU"] and sum(switched.values()) >= 3
    lu = names.index("LU")
    assert sel[4, lu] != sel[0, lu]
    assert (np.diff(E) <= 1e-6).all()


GRID300 = dict(faults=FAULTS, seeds=[0, 1], warm_start=True)


@pytest.mark.parametrize("totals_only", [False, True])
def test_faulty_stream_grid_matches(stream300, totals_only):
    """300-job Poisson stream, stragglers + failures, 3 K x 2 seeds."""
    pol = r_make("paper", k=np.array([0.0, 0.1, 0.3], np.float32))
    rr, tr = _run_both(stream300, pol, totals_only, **GRID300)
    _assert_parity(rr, tr)


def test_fused_multiply_adds_are_load_bearing(stream300, monkeypatch):
    """With plain (twice-rounded) multiply-adds in place of the fused
    sites, the port departs from the reference: ``finish`` first at job
    74 (K=0, seed 1) and the learned tables over the stream, while no
    placement flips.  So the fused sites in ``utils/fp`` are what makes
    the parity exact."""
    import repro_torch.core.dvfs as t_dvfs
    import repro_torch.core.engine as t_engine
    import repro_torch.core.policy as t_policy
    plain = lambda a, b, c: a * b + c  # noqa: E731
    for mod in (t_engine, t_dvfs, t_policy):
        monkeypatch.setattr(mod, "fma", plain)
    pol = r_make("paper", k=np.array([0.0, 0.1, 0.3], np.float32))
    rr, tr = _run_both(stream300, pol, **GRID300)
    np.testing.assert_array_equal(tr.system.numpy(), np.asarray(rr.system))
    bad = np.argwhere(tr.finish.numpy() != np.asarray(rr.finish))
    assert tuple(bad[np.argmin(bad[:, -1])]) == (0, 1, 74)
    assert (tr.C_tab.numpy() != np.asarray(rr.C_tab)).any()
    assert (tr.T_tab.numpy() != np.asarray(rr.T_tab)).any()


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("name", FCFS_ENTRIES)
def test_registry_entry_matches(stream60, name, warm):
    """Every FCFS registry entry, warm and cold, with faults and outage
    windows, over a 2-point K grid and two seeds."""
    pol = r_make(name, k=np.array([0.0, 0.2], np.float32))
    rr, tr = _run_both(stream60, pol, faults=FAULTS, seeds=[0, 1],
                       warm_start=warm)
    _assert_parity(rr, tr)


@pytest.mark.parametrize("totals_only", [False, True])
def test_outage_windows_and_per_job_k_match(totals_only):
    out = maintenance_windows(4, {0: [(100.0, 400.0)],
                                  1: [(10.0, 30.0), (30.0, 200.0)],
                                  2: [(50.0, 80.0), (300.0, 900.0)]})
    kj = np.full(150, np.nan, np.float32)
    kj[::3] = 0.25
    w = r_stream(R_SYSTEMS, 150, "bursty", rate=0.5, seed=1, outage=out,
                 k_job=kj)
    rr, tr = _run_both(w, "dvfs_queue_aware", totals_only, faults=FAULTS,
                       seeds=[5])
    _assert_parity(rr, tr)


def test_campaign_axes_index_and_metrics(stream60):
    faults = [{}, FAULTS]
    pol = r_make("dvfs_paper", k=np.array([0.0, 0.1, 0.2], np.float32),
                 freq_weight=np.array([0.0, 1e-6, 5e-6], np.float32))
    rr, tr = _run_both(stream60, pol, faults=faults, seeds=[0, 1],
                       warm_start=True)
    assert isinstance(tr, CampaignResult)
    assert tr.axes == ("fault", "policy", "seed")
    assert tr.system.shape == (2, 3, 2, 60)
    _assert_parity(rr, tr)
    for f in ("mean_wait", "mean_slowdown", "utilization", "tier_counts",
              "tier_energy"):
        a, b = np.asarray(getattr(rr, f)), getattr(tr, f).numpy()
        if f in ("tier_counts",):
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=f)
    one = tr.index(fault=1, seed=0)
    ref_one = rr.index(fault=1, seed=0)
    assert one.axes == ("policy",) and "fault" not in one.coords
    _assert_parity(ref_one, one)
    point = tr.index(fault=0, policy=2, seed=1)
    assert type(point) is SimResult and point.axes == ()
    np.testing.assert_array_equal(point.system.numpy(),
                                  np.asarray(rr.system)[0, 2, 1])
    assert set(tr.to_dict(arrays=False)) == set(rr.to_dict(arrays=False))
    with pytest.raises(KeyError):
        tr.index(bogus=0)
    with pytest.raises(TypeError):
        tr.index(seed=slice(0, 1))


def test_scalar_run_and_placers_agree(stream60):
    w = workload_from_reference(stream60)
    runs = {p: TScheduler("ucb", placer=p, device="cpu", warm_start=True)
            .run(w) for p in (None, "torch", "sort")}
    assert all(type(r) is SimResult and r.axes == () for r in runs.values())
    for p in ("torch", "sort"):
        for f in ("system", "start", "finish", "energy", "total_energy"):
            assert torch.equal(getattr(runs[None], f), getattr(runs[p], f))
