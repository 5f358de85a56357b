"""Port parity: live sessions of the online scheduler service against
the port's and the reference's batch runs, on the longer streams.

A live ``Dispatcher`` session under failure re-queue, and on the
reference ablation's 250-job SWF stream under the three window-16
queues, equals the port's ``Scheduler(..., engine="events").run`` bit
for bit on every ``FIELDS`` entry, and the reference's batch run bit for
bit on every entry but the three sums over jobs (rtol 1e-6).  The
helpers are ``test_torch_service.py``'s.
"""

import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import JSCC_SYSTEMS as R_SYSTEMS  # noqa: E402
from repro.core import make_npb_workload as r_npb  # noqa: E402
from repro.core import make_policy as r_make  # noqa: E402
from test_torch_service import (FAILS, REDUCED,  # noqa: E402,F401
                                _one_thread, _sessions,
                                assert_bit_identical,
                                assert_decisions_match)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "benchmarks"))


@pytest.mark.parametrize("queue", ["fcfs", "conservative:window=4"])
def test_live_failure_requeue_session(queue):
    """Failure re-queue: failed first attempts go back into the live
    buffer as in the batch run (more placements than finished jobs)."""
    w = r_npb(R_SYSTEMS, repeats=3,
              arrivals=np.arange(15, dtype=np.float32) * 20.0)
    live, batch, ref = _sessions(w, r_make("paper", k=0.1), faults=FAILS,
                                 warm_start=True, queue=queue, seed=3)
    res = live.result()
    assert_bit_identical(batch, res)
    assert_bit_identical(ref, res, banded=REDUCED)
    assert live.metrics.n_placed > live.metrics.n_finished == len(w.prog)
    assert_decisions_match(live, res)


@pytest.mark.parametrize("queue", ["fcfs", "easy_backfill:window=16",
                                   "conservative:window=16"])
def test_live_replay_swf_stream(queue):
    """The reference ablation's 250-job SWF stream under the three
    window-16 queues: live == the port's batch run, and the reference's
    batch run (not its live run, which departs from it here)."""
    from scheduler_ablation import queue_streams
    w = queue_streams()["swf"]
    live, batch, ref = _sessions(w, r_make("paper", k=0.10),
                                 warm_start=True, queue=queue)
    res = live.result()
    assert_bit_identical(batch, res)
    assert_bit_identical(ref, res, banded=REDUCED)
    assert_decisions_match(live, res)
