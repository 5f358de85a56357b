"""Port parity: ``easy_eval="unrolled"``, the reference's per-slot EASY
loop (``_easy_run``'s ``unrolled_step``).

* against the reference's unrolled loop on three small cases (one lane
  with warm tables; two seeds with stragglers and failures, cold; a K
  grid with outage windows on the ``totals_only`` path): decisions
  (``system``, ``backfilled``, ``runs``, ``n_backfilled``) exact; per-job
  floats, ``busy``, ``makespan``, ``max_wait`` and the learned
  ``C_tab`` / ``T_tab`` exact too (the unrolled step fuses ``old * n`` in
  the table update at any lane count, as the reference's does); the
  full path's sums over jobs within rtol 1e-6 (``torch.sum``'s order,
  PERF.md "Parity bands"); the ``totals_only`` Kahan sums exact;
* against the port's batched EASY over every untiered registry entry on
  ``stream80`` (``tests/test_torch_easy.py``): placements and starts
  exact (``finish`` is ``start + runtime`` fused into one multiply-add in
  the unrolled step and a plain add in the batched one, as in the
  reference: an ulp apart where a fault factor scales the runtime);
* chunked (``chunk=``) and sharded (``shards=``) unrolled runs equal the
  monolithic one on every field;
* tiered policies raise the reference's ``ValueError``;
* 2 W + 2 kth-free launches a step, by the CUDA wrapper's counter (a
  CPU stand-in for the kernel, ``placer="cuda"``); the batched step's 2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import JSCC_SYSTEMS as R_SYSTEMS  # noqa: E402
from repro.core import FaultConfig as RFault  # noqa: E402
from repro.core import Scheduler as RScheduler  # noqa: E402
from repro.core.policy import apply_queue_spec  # noqa: E402
from repro.core.policy import make_policy as r_make  # noqa: E402
from repro.core.policy import policy_names  # noqa: E402
from repro.data import scenarios as rs  # noqa: E402
from repro_torch.convert import (policy_from_reference,  # noqa: E402
                                 workload_from_reference)
from repro_torch.core import FaultConfig as TFault  # noqa: E402
from repro_torch.core import Scheduler as TScheduler  # noqa: E402
from repro_torch.kernels.kth_free import ops as kth_ops  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.kernels.kth_free.kernel import radix_select_kth  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

DECISIONS = ("system", "backfilled", "runs", "n_backfilled")
FLOATS = ("start", "finish", "wait", "energy", "runtime", "busy",
          "makespan", "max_wait", "C_tab", "T_tab")
SUMS = ("total_energy", "total_wait", "slowdown_sum")
FAULTS = dict(straggler_prob=0.1, failure_prob=0.05)
UNTIERED = tuple(n for n in policy_names()
                 if r_make(n).queue in ("fcfs", "easy_backfill")
                 and not r_make(n).tiered)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread, as the other port test files: the driver runs
    six workers on this machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _contended(n=40, seed=3, outage=None):
    """High arrival rate: held heads and live backfill candidates."""
    return rs.make_stream_workload(R_SYSTEMS, n, arrival="poisson",
                                   rate=1.0, seed=seed, pred_noise=0.05,
                                   outage=outage)


def _easy(name, window, **params):
    return apply_queue_spec(r_make(name, **params),
                            f"easy_backfill:window={window}")


CASES = {
    "one-lane-warm": dict(pol=("paper", 6, {"k": 0.1}), seeds=7, warm=True,
                          faults=None, totals_only=False, outage=None),
    "seeds-faults-cold": dict(pol=("queue_aware", 6, {"k": 0.1}),
                              seeds=[7, 8], warm=False, faults=FAULTS,
                              totals_only=False, outage=None),
    "kgrid-outage-totals": dict(
        pol=("ucb", 4, {"k": np.array([0.0, 0.2], np.float32)}), seeds=0,
        warm=True, faults=None, totals_only=True,
        outage={0: [(2.0, 9.0)], 2: [(1.0, 4.0), (6.0, 20.0)]}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_unrolled_matches_reference_unrolled(case):
    c = CASES[case]
    out = None if c["outage"] is None else rs.maintenance_windows(
        4, c["outage"])
    w = _contended(outage=out)
    name, window, params = c["pol"]
    pol = _easy(name, window, **params)
    kw = dict(seeds=c["seeds"], warm_start=c["warm"])
    rr = RScheduler(pol, easy_eval="unrolled",
                    faults=None if c["faults"] is None
                    else RFault(**c["faults"]), **kw).run(
        w, totals_only=c["totals_only"])
    tr = TScheduler(policy_from_reference(pol), easy_eval="unrolled",
                    faults=None if c["faults"] is None
                    else TFault(**c["faults"]), device="cpu", **kw).run(
        workload_from_reference(w), totals_only=c["totals_only"])
    assert int(np.asarray(rr.n_backfilled).sum()) > 0
    for f in DECISIONS + FLOATS + SUMS:
        a, b = getattr(rr, f), getattr(tr, f)
        if a is None:
            assert b is None, f
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, f
        if f in SUMS and not c["totals_only"]:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.fixture(scope="module")
def stream80():
    out = rs.maintenance_windows(4, {0: [(20.0, 60.0)],
                                     2: [(5.0, 9.0), (40.0, 90.0)]})
    return workload_from_reference(rs.make_stream_workload(
        R_SYSTEMS, 80, "poisson", rate=0.5, seed=4, outage=out))


@pytest.mark.parametrize("name", UNTIERED)
def test_unrolled_places_as_batched(stream80, name):
    """Every untiered registry entry under EASY (window 4), cold, with
    faults, over a 2-point K grid and two seeds."""
    pol = policy_from_reference(_easy(name, 4, k=np.array([0.0, 0.2],
                                                          np.float32)))
    kw = dict(device="cpu", seeds=[0, 1], faults=TFault(**FAULTS))
    ru = TScheduler(pol, easy_eval="unrolled", **kw).run(stream80)
    rb = TScheduler(pol, **kw).run(stream80)
    for f in ("system", "tier", "nodes", "start", "backfilled", "runs",
              "n_backfilled"):
        assert torch.equal(getattr(ru, f), getattr(rb, f)), f


@pytest.mark.parametrize("totals_only", [False, True],
                         ids=["full", "totals"])
def test_unrolled_chunked_and_sharded_equal_monolithic(monkeypatch,
                                                       totals_only):
    """The chunk and shard drivers take the unrolled loop as they take
    the batched one: 4 lanes over 3 CPU "devices" (padded to 6), chunks
    of 7 steps; every field equal to the monolithic run."""
    cpus = [torch.device("cpu")] * 3
    monkeypatch.setattr(mesh, "make_grid_devices",
                        lambda shards, device=None: cpus[:int(shards)])
    pol = policy_from_reference(_easy("paper", 4, k=np.array([0.0, 0.2],
                                                             np.float32)))
    w = workload_from_reference(_contended(24))
    kw = dict(easy_eval="unrolled", device="cpu", seeds=[0, 1],
              faults=TFault(**FAULTS))
    base = TScheduler(pol, **kw).run(w, totals_only=totals_only)
    got = TScheduler(pol, chunk=7, shards=3, **kw).run(
        w, totals_only=totals_only)
    for f in DECISIONS + FLOATS + SUMS:
        a, b = getattr(base, f), getattr(got, f)
        assert (a is None and b is None) or torch.equal(a, b), f


def test_tiered_policies_raise():
    pol = policy_from_reference(_easy("dvfs_paper", 4, k=0.1))
    w = workload_from_reference(_contended(10))
    with pytest.raises(ValueError, match="freq_tiers"):
        TScheduler(pol, easy_eval="unrolled", device="cpu").run(w)
    TScheduler(pol, device="cpu").run(w)       # the batched step runs


@pytest.mark.parametrize("easy_eval,window", [("unrolled", 4),
                                              ("unrolled", 7),
                                              ("batched", 4)])
def test_kth_free_launches_per_step(monkeypatch, easy_eval, window):
    """The CUDA wrapper's count a step, with a CPU stand-in for the
    kernel: the unrolled step makes 2 W + 2 calls (head, W slots with
    their rechecks, the chosen job), the batched step 2."""
    calls = []

    def stand_in(node_free, n_req):
        calls.append(tuple(node_free.shape))
        return radix_select_kth(node_free, n_req)

    monkeypatch.setattr(kth_ops, "kth_free_cuda", stand_in)
    w = workload_from_reference(_contended(12))
    pol = policy_from_reference(_easy("paper", window, k=0.1))
    TScheduler(pol, placer="cuda", easy_eval=easy_eval, device="cpu",
               seeds=[0, 1]).run(w)
    steps = 12 + window
    per_step = 2 * window + 2 if easy_eval == "unrolled" else 2
    assert len(calls) == per_step * steps
