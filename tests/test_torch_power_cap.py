"""Port parity: SCC power caps on the event-granular cores (FCFS, EASY
and conservative), cap grids, the stuck valve below the idle floor,
capped starts inside maintenance windows and DVFS tiers under a cap
grid, against the reference; and the cluster-draw sum's order.

Tolerances as in ``tests/test_torch_events.py`` (PERF.md "Parity
bands"): every field exact, ``peak_power`` and ``capped_delay`` too (the
port adds the draw in the reference's order), but the full path's sums
over jobs within rtol 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import JSCC_SYSTEMS as R_SYSTEMS  # noqa: E402
from repro.core import Scheduler as RScheduler  # noqa: E402
from repro.core import make_npb_workload as r_npb  # noqa: E402
from repro.core.policy import apply_queue_spec  # noqa: E402
from repro.core.policy import make_policy as r_make  # noqa: E402
from repro.data import scenarios as rs  # noqa: E402
from repro_torch.convert import (policy_from_reference,  # noqa: E402
                                 workload_from_reference)
from repro_torch.core import Scheduler as TScheduler  # noqa: E402
from repro_torch.core import events  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

EXACT = ("system", "tier", "nodes", "start", "finish", "wait", "energy",
         "runtime", "backfilled", "runs", "C_tab", "T_tab", "busy",
         "makespan", "max_wait", "idle_energy", "n_backfilled",
         "capped_delay", "peak_power")
REDUCED = ("total_energy", "total_wait", "slowdown_sum")
QUEUES = ("fcfs", "easy_backfill:window=4", "conservative:window=8")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The event steps are many small ops: one intra-op thread keeps the
    test workers, which share the cores, from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(n=35, rate=1.0, seed=3, **kw):
    return rs.make_stream_workload(R_SYSTEMS, n, arrival="poisson",
                                   rate=rate, seed=seed, pred_noise=0.05,
                                   **kw)


def _run_both(w, policy, totals_only=False, **kw):
    rr = RScheduler(policy, **kw).run(w, totals_only=totals_only)
    tr = TScheduler(policy_from_reference(policy), device="cpu", **kw).run(
        workload_from_reference(w), totals_only=totals_only)
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


@pytest.mark.parametrize("queue", QUEUES)
def test_cap_binds_and_matches(queue):
    """A 45 kW cap on every queue: equal to the reference, the peak under
    the cap, and the cap really binds (delay > 0)."""
    pol = apply_queue_spec(r_make("paper", k=0.1), queue)
    rr, tr = _run_both(_stream(), pol, warm_start=True, power_cap=45_000.0)
    _assert_parity(rr, tr)
    assert float(tr.peak_power) <= 45_000.0
    assert float(tr.capped_delay) > 0.0


@pytest.mark.parametrize("totals_only", [False, True],
                         ids=["full", "totals"])
def test_cap_grid_is_lanes(totals_only):
    """A (K x cap) leaf grid under conservative runs as lanes of one run:
    equal to the reference lane for lane; the uncapped lane's peak is the
    draw sampled at placements."""
    pol = r_make("conservative", k=np.linspace(0.0, 0.3, 4).astype(np.float32),
                 power_cap=np.array([40e3, 50e3, 60e3, 1e30], np.float32))
    rr, tr = _run_both(_stream(n=30), pol, totals_only, warm_start=True)
    assert tr.axes == ("policy",)
    _assert_parity(rr, tr)
    assert (tr.peak_power[:3] <= torch.tensor([40e3, 50e3, 60e3])).all()


def test_cap_below_the_idle_floor_forces_progress():
    """A cap at half the all-idle draw is unsatisfiable: the stuck valve
    forces the head once no event is left, so every job is placed and
    the peak honestly exceeds the cap."""
    w = _stream(n=10, rate=0.8)
    idle_floor = float(np.sum(w.idle_w * w.n_nodes))
    rr, tr = _run_both(w, r_make("paper"), warm_start=True,
                       power_cap=idle_floor * 0.5)
    _assert_parity(rr, tr)
    assert (tr.runtime > 0).all()
    assert float(tr.peak_power) > idle_floor * 0.5


@pytest.mark.parametrize("queue", ["fcfs", "conservative"])
def test_capped_starts_respect_outage_windows(queue):
    """A start the cap defers quantizes to the current event, which must
    itself clear the maintenance windows: no job starts inside one."""
    out = rs.maintenance_windows(4, {2: [(100.0, 700.0)],
                                     3: [(100.0, 700.0)]})
    w = _stream(n=40, rate=1.2, seed=1, outage=out)
    pol = apply_queue_spec(r_make("paper", k=0.1), queue)
    rr, tr = _run_both(w, pol, warm_start=True, power_cap=45_000.0)
    _assert_parity(rr, tr)
    start, sel = tr.start.numpy(), tr.system.numpy()
    inside = np.isin(sel, [2, 3]) & (start >= 100.0) & (start < 700.0)
    assert not inside.any()


@pytest.mark.parametrize("queue", ["fcfs", "conservative"])
def test_dvfs_tiers_under_a_cap_grid(queue):
    """``dvfs_paper`` over a cap x freq_weight x K lattice on the NPB
    suite submitted four times (``benchmarks/dvfs_pareto.py`` in small):
    the per-tier draw enters the power test; binding caps hold."""
    w = r_npb(R_SYSTEMS, repeats=4)
    caps, fws, ks = (x.ravel() for x in np.meshgrid(
        np.array([45e3, 55e3, 1e30], np.float32),
        np.array([0.0, 1e-6], np.float32),
        np.array([0.10, 0.50], np.float32), indexing="ij"))
    pol = apply_queue_spec(r_make("dvfs_paper", k=ks, freq_weight=fws,
                                  power_cap=caps), queue)
    rr, tr = _run_both(w, pol, warm_start=True)
    _assert_parity(rr, tr)
    assert int(tr.tier.max()) > 0
    peak = tr.peak_power.numpy()
    assert (peak[caps < 1e29] <= caps[caps < 1e29]).all()


def test_power_sum_order_is_load_bearing(monkeypatch):
    """The cluster draw added in ``torch.sum``'s order in place of the
    reference's window order moves ``peak_power`` off the reference's by
    an ulp, while every placement stays."""
    pol = apply_queue_spec(r_make("paper", k=0.1), "conservative:window=8")
    rr, _ = _run_both(_stream(), pol, warm_start=True, power_cap=45_000.0)
    monkeypatch.setattr(events, "_cluster_power",
                        lambda draw, order: draw.sum((1, 2)))
    tr = TScheduler(policy_from_reference(pol), warm_start=True,
                    power_cap=45_000.0, device="cpu").run(
        workload_from_reference(_stream()))
    np.testing.assert_array_equal(tr.system.numpy(), np.asarray(rr.system))
    assert float(tr.peak_power) != float(rr.peak_power)


def test_cluster_power_adds_in_window_order():
    """``_cluster_power`` equals one float32 add per element in the
    ``power_order`` (window by window, row by row, then the window sums)
    on random tables of three widths, and differs from float64 summation
    rounded once on at least one of them."""
    g = torch.Generator().manual_seed(0)
    differs = False
    for S, N in ((4, 136), (3, 100), (2, 10)):
        draw = torch.rand((5, S, N), generator=g) * 400
        order = events.power_order(S, N, "cpu")
        got = events._cluster_power(draw, order)
        idx, offsets, _ = order
        flat = draw.reshape(5, -1)[:, idx].numpy()
        for b in range(5):
            total = np.float32(0)
            for lo, hi in zip(offsets[:-1].tolist(), offsets[1:].tolist()):
                part = np.float32(0)
                for v in flat[b, lo:hi]:
                    part = np.float32(part + v)
                total = np.float32(total + part)
            assert got[b].item() == total
        differs |= bool((got != draw.double().sum((1, 2)).float()).any())
    assert differs


@pytest.mark.parametrize("kwargs", [{"power_cap": 50_000.0},
                                    {"queue": "conservative"}])
def test_arrival_engine_refuses_caps_and_conservative(kwargs):
    """The arrival-indexed scan cannot defer placements: as in the
    reference, a cap or a conservative queue there is a ValueError."""
    with pytest.raises(ValueError, match="event-"):
        TScheduler("paper", engine="arrival", device="cpu", **kwargs)
