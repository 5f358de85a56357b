"""Port parity over the event cores' map of fused multiply-adds.

The reference's compiled event and conservative steps contract a
multiply-add into one rounding at some sites and not at others, and
which ones depends on the queue, the lane count and the re-queue
(``events._fusions``; the reservation finish in ``events._reserve``).
Each case here runs one cell of that map, queue x lanes {1, 3} x
failure re-queue x DVFS tiers, against the reference's ``Scheduler``
on the same stream, with faults whose factors round (2.5, 0.37) so that
a fused site taken as plain, or a plain one taken as fused, moves a
table, a finish or a placement.  Every field is exact but the full
path's sums over jobs (``rtol=1e-6``, added in another order).
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
from _jax_caches import release_compiled  # noqa: E402,F401

EXACT = ("system", "tier", "nodes", "start", "finish", "wait", "energy",
         "runtime", "backfilled", "runs", "C_tab", "T_tab", "busy",
         "makespan", "max_wait", "idle_energy", "n_backfilled",
         "capped_delay", "peak_power")
REDUCED = ("total_energy", "total_wait", "slowdown_sum")
QUEUES = {"fcfs": None, "easy": "easy_backfill:window=4",
          "conservative": "conservative:window=6"}
STRAGGLERS = dict(straggler_prob=0.5, straggler_factor=2.5)
RETRIES = dict(STRAGGLERS, failure_prob=0.3, restart_overhead=0.37)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The event steps are many small ops: one intra-op thread keeps the
    test workers, which share the cores, from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("tiers", [False, True], ids=["flat", "tiers"])
@pytest.mark.parametrize("retries", [False, True],
                         ids=["stragglers", "retries"])
@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("queue", list(QUEUES))
def test_fused_site_map_matches(queue, lanes, retries, tiers):
    w = rs.make_stream_workload(R_SYSTEMS, 40, arrival="poisson", rate=1.0,
                                seed=2, pred_noise=0.05)
    k = np.linspace(0.0, 0.3, lanes).astype(np.float32) if lanes > 1 else 0.1
    pol = r_make("dvfs_paper" if tiers else "paper", k=k)
    if QUEUES[queue]:
        pol = apply_queue_spec(pol, QUEUES[queue])
    faults = RETRIES if retries else STRAGGLERS
    kw = dict(warm_start=True, engine="events")
    rr = RScheduler(pol, faults=RFault(**faults), **kw).run(w)
    tr = TScheduler(policy_from_reference(pol), faults=TFault(**faults),
                    device="cpu", **kw).run(workload_from_reference(w))
    for f in EXACT + REDUCED:
        a, b = np.asarray(getattr(rr, f)), getattr(tr, f).cpu().numpy()
        assert a.shape == b.shape, f
        if f in REDUCED:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f)
        elif not np.array_equal(a, b, equal_nan=True):
            first = np.argwhere(a != b)[0].tolist()
            raise AssertionError(f"{f} differs first at {first}: "
                                 f"{a[tuple(first)]!r} != {b[tuple(first)]!r}")
    assert (np.asarray(tr.runtime) > 0).all()
