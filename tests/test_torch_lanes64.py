"""Port parity at 64 lanes: the event core's FCFS with failure re-queue
and event-driven EASY, a (16 K x 4 seed) grid, against the reference's
``Scheduler(..., engine="events")`` on a short stream.

The fused multiply-add sites depend on the core and the lane count
(``events._fusions``); ``tests/test_torch_fusion_map.py`` holds lanes 1
and 3 and ``tests/test_torch_sharded.py`` 10 to 16.  The card runs 64
lanes (``chip_smoke.py``'s ``campaign_scale`` and ``service_pool``
phases), so this holds that width against the reference, with faults
whose factors round (2.5, 0.37) so that a site taken wrongly moves a
table, a finish or a placement.  Every field is exact but the sums over
jobs (rtol 1e-6, added in another order).
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

from test_torch_fusion_map import EXACT, REDUCED, RETRIES  # noqa: E402

KS = np.linspace(0.0, 0.3, 16).astype(np.float32)
SEEDS = (0, 1, 2, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("queue", [None, "easy_backfill:window=4"],
                         ids=["fcfs_requeue", "easy_requeue"])
def test_64_lanes_match_the_reference(queue):
    w = rs.make_stream_workload(R_SYSTEMS, 16, arrival="poisson", rate=1.0,
                                seed=2, pred_noise=0.05)
    pol = r_make("paper", k=KS)
    if queue:
        pol = apply_queue_spec(pol, queue)
    kw = dict(warm_start=True, engine="events", seeds=SEEDS)
    rr = RScheduler(pol, faults=RFault(**RETRIES), **kw).run(w)
    tr = TScheduler(policy_from_reference(pol), faults=TFault(**RETRIES),
                    device="cpu", **kw).run(workload_from_reference(w))
    assert tuple(tr.system.shape[:2]) == (16, 4)
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
