"""Campaign scale, memory: a chunked ``totals_only`` run
(``Scheduler(chunk=64)``, J = 600 jobs, B = 6 lanes, each core) makes no
tensor of two or more dimensions with a dimension of J or more.  A
``TorchDispatchMode`` watches the outputs of every op of the run.  J lies
above every other size of the run: maxN 136 and the [B, S x maxN] = [6,
544] cluster draw the event cores sum, the window of W + 1 + chunk + 1 =
72 job ids, the 64-step chunk; only the 1-D [J] workload arrays reach
it.  As the control, the monolithic run, with its [B, J] draws, is caught.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

from repro_torch.core import JSCC_SYSTEMS, Scheduler  # noqa: E402
from repro_torch.core import parse_policy_spec  # noqa: E402
from repro_torch.data import make_stream_workload  # noqa: E402

CORES = {
    "fcfs": dict(policy="paper"),
    "easy": dict(policy="easy_backfill:window=6"),
    "events": dict(policy="paper", engine="events"),
    "conservative": dict(policy="conservative:window=6"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _NoJobDim(TorchDispatchMode):
    """Raises at the first op whose output has two or more dimensions,
    one of them J or longer."""

    def __init__(self, J):
        super().__init__()
        self.J = J

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in ((out,) if isinstance(out, torch.Tensor)
                  else tree_flatten(out)[0]):
            if (isinstance(t, torch.Tensor) and t.dim() >= 2
                    and max(t.shape) >= self.J):
                raise AssertionError(f"{func} made {tuple(t.shape)}")
        return out


J_MEM = 600
B_MEM = 6
CHUNK_MEM = 64


@pytest.fixture(scope="module")
def stream_mem():
    return make_stream_workload(JSCC_SYSTEMS, J_MEM, arrival="poisson",
                                rate=0.5, seed=1)


def _mem_sched(core, chunk):
    spec = dict(CORES[core])
    pol = parse_policy_spec(spec.pop("policy")).with_params(
        k=np.array([0.0, 0.1], np.float32))
    return Scheduler(pol, warm_start=True, seeds=[0, 1, 2], device="cpu",
                     chunk=chunk, **spec)


@pytest.mark.parametrize("core", CORES)
def test_chunked_totals_only_has_no_job_sized_tensor(stream_mem, core):
    """Chunked, no tensor of two or more dimensions reaches J; the
    monolithic run's [B, J] draws do (the control)."""
    assert J_MEM > max(4 * 136, 6 + 1 + CHUNK_MEM + 1)
    with _NoJobDim(J_MEM):
        res = _mem_sched(core, CHUNK_MEM).run(stream_mem, totals_only=True)
    assert res.total_energy.shape == (2, 3)
    assert bool(torch.isfinite(res.total_energy).all())
    with pytest.raises(AssertionError, match=f"{B_MEM}, {J_MEM}"):
        with _NoJobDim(J_MEM):
            _mem_sched(core, None).run(stream_mem, totals_only=True)
