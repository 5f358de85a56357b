"""The port's tracer (``repro_torch.utils.trace``) and the spans and
counters of the campaign path (``core/engine.py``,
``kernels/kth_free/ops.py``).  No JAX: the port alone.

Off, the tracer records nothing and a campaign's fields are bit-equal with
it on.  On, every campaign is one ``run`` tree: ``run.steps`` holds one
``step`` a step (J for FCFS, J + W for EASY), each step its phases, and no
span lies outside its parent's host interval; kth_free counts one call a
public entry in the span of its call site.  The ``gpu`` cases hold the
spans' device times and the profiler's clock on the card.
"""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (JSCC_SYSTEMS, FaultConfig, Scheduler,  # noqa: E402
                              make_npb_workload)
from repro_torch.kernels.kth_free import ops as kth_ops  # noqa: E402
from repro_torch.kernels.kth_free.kernel import kth_free_cuda  # noqa: E402
from repro_torch.launch import schedule  # noqa: E402
from repro_torch.utils import trace  # noqa: E402

J, W = 20, 4
QUEUES = {"fcfs": "fcfs", "easy": f"easy_backfill:window={W}"}
PHASES = {"fcfs": ("fcfs.earliest", "fcfs.select", "fcfs.commit"),
          "easy": ("easy.push", "easy.score", "easy.trial", "easy.recheck",
                   "easy.commit")}
FACADE = ("run.workload_arrays", "run.setup", "run.job_draws", "run.steps",
          "run.results")


def _workload(n=J):
    rng = np.random.default_rng(3)
    order = tuple(rng.choice(["BT", "EP", "IS", "LU", "SP"], n))
    return make_npb_workload(JSCC_SYSTEMS, order=order,
                             arrivals=np.cumsum(rng.exponential(2.0, n)))


def _scheduler(queue, device="cpu", seeds=(1, 2)):
    """4 lanes: K {0, 0.2} x 2 seeds, stragglers and failures."""
    from repro_torch.core import make_policy
    pol = make_policy("paper", k=np.asarray([0.0, 0.2], np.float32))
    return Scheduler(pol, seeds=seeds, warm_start=True, queue=QUEUES[queue],
                     faults=FaultConfig(0.2, 2.0, 0.1, 0.5), device=device)


def _fields(res):
    return {k: v for k, v in vars(res).items() if torch.is_tensor(v)}


def _same_bits(x, y) -> bool:
    """Bit-equal tensors (NaN totals included)."""
    if x.is_floating_point():
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
        x, y = x.view(bits), y.view(bits)
    return torch.equal(x, y)


def _children(rec, span):
    return [s for s in rec.spans if s.parent == span.id]


@pytest.mark.parametrize("queue", sorted(QUEUES))
def test_off_records_nothing_and_on_is_bit_equal(queue):
    w = _workload()
    assert trace._rec is None
    assert trace.span("step", j=0) is trace.span("run")
    trace.count("kth_free.calls")
    off = _fields(_scheduler(queue).run(w))
    with trace.collect() as rec:
        assert trace._rec is rec
        on = _fields(_scheduler(queue).run(w))
    assert trace._rec is None and rec.spans
    assert off.keys() == on.keys()
    for name, x in off.items():
        assert _same_bits(x, on[name]), name
    # a recording holds only what ran while it was open
    with trace.collect() as empty:
        pass
    assert empty.spans == [] and empty.counts == {}


@pytest.mark.parametrize("queue", sorted(QUEUES))
def test_one_run_tree_a_campaign(queue):
    w = _workload()
    with trace.collect() as rec:
        _scheduler(queue).run(w)
        _scheduler(queue, seeds=(5, 6)).run(w, totals_only=True)
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == ["run", "run"]
    assert all(s.attrs["B"] == 4 and s.attrs["J"] == J for s in roots)
    n_steps = J if queue == "fcfs" else J + W
    for root in roots:
        kids = _children(rec, root)
        assert {s.name for s in kids} <= set(FACADE)
        steps_parents = [s for s in kids if s.name == "run.steps"]
        steps = [s for p in steps_parents for s in _children(rec, p)]
        assert len(steps) == n_steps and {s.name for s in steps} == {"step"}
        assert [s.attrs.get("j", s.attrs.get("t")) for s in steps] \
            == list(range(n_steps))
        for st in steps:
            assert [s.name for s in _children(rec, st)] == list(PHASES[queue])
    # every phase sits in a step; every span of a campaign descends from
    # its run; no child outside its parent's host interval
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name in PHASES[queue]:
            assert by_id[s.parent].name == "step"
        top = s
        while top.parent is not None:
            top = by_id[top.parent]
        assert top in roots
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    names = {s.name for s in rec.spans}
    assert {"run.workload_arrays", "run.setup", "run.job_draws",
            "run.results"} <= names


@pytest.mark.parametrize("queue", sorted(QUEUES))
def test_kth_free_calls_by_call_site(queue):
    w = _workload()
    with trace.collect() as rec:
        _scheduler(queue).run(w)
    if queue == "fcfs":
        want = {"fcfs.earliest": J}
        rows = {"fcfs.earliest": J * 4 * len(JSCC_SYSTEMS)}
    else:
        want = {"easy.score": J + W, "easy.recheck": J + W}
        rows = {"easy.score": (J + W) * 4 * (W + 1) * len(JSCC_SYSTEMS),
                "easy.recheck": (J + W) * 4 * (W + 1)}
    assert rec.by_span("kth_free.calls") == want
    assert rec.by_span("kth_free.rows") == rows
    assert rec.total("kth_free.calls") == sum(want.values())
    for st in rec.named("step"):
        assert "kth_free.calls" not in st.counts


@pytest.mark.parametrize("mode", ["torch", "sort"])
def test_each_public_entry_counts_once(mode):
    """The shared and rows entries select through ``kth_free_time``; the
    call counts once, in every mode, outside any span too."""
    g = torch.Generator().manual_seed(0)
    free = torch.rand((3, 2, 8), generator=g)
    nreq = torch.randint(1, 9, (3, 5, 2), generator=g)
    with trace.collect() as rec:
        kth_ops.kth_free_time(free, nreq[:, 0], force=mode)
        kth_ops.kth_free_time_shared(free, nreq, force=mode)
        with trace.span("rows"):
            kth_ops.kth_free_time_rows(free, nreq[..., 0] % 2, nreq[..., 1],
                                       force=mode)
    assert rec.counts == {"kth_free.calls": 2, "kth_free.rows": 6 + 30}
    assert rec.by_span("kth_free.calls") == {"rows": 1}
    assert rec.by_span("kth_free.rows") == {"rows": 15}


def test_collect_does_not_nest_and_records_its_own_thread():
    with trace.collect() as rec:
        with pytest.raises(RuntimeError):
            with trace.collect():
                pass
        t = threading.Thread(target=lambda: trace.span("other").__enter__())
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with trace.span("mine", x=1):
            trace.count("c", 3)
    assert [(s.name, s.attrs, s.counts) for s in rec.spans] \
        == [("mine", {"x": 1}, {"c": 3})]
    assert trace._rec is None


def test_schedule_cli_writes_spans(tmp_path, capsys):
    out = tmp_path / "spans.json"
    schedule.main(["--device", "cpu", "--jobs", "12", "--queue",
                   "easy_backfill:window=4", "--spans-out", str(out)])
    assert "placements:" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["tid"] for e in spans} == {0}        # no stream track off the card
    names = [e["name"] for e in spans]
    assert names.count("run") == 1 and names.count("step") == 12 + 4
    assert sum(e["args"].get("kth_free.calls", 0) for e in spans) == 2 * 16
    assert all(e["dur"] >= 0 for e in spans)


# ---- on the card ----------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


#: how far the profiler's clock may stray from the span's on the card:
#: CUPTI maps the device's timestamps onto the host's (an H100 with torch
#: 2.11 read a kernel 34 us before the span that launched it)
CLOCK_SLACK_NS = 200_000


@pytest.mark.gpu
def test_span_and_profiler_share_one_clock():
    """A span around a sleeping kernel, under the device-only profiler: on
    the Unix clock, the kernel runs inside the span's host interval (within
    the clocks' slack) and starts within 1 ms of it."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with trace.collect() as rec:
            with trace.span("sleep") as sp:
                torch.cuda._sleep(20_000_000)
                torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    # the sleeping kernel (``spin_kernel``) is the one device operation
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
    assert len(kernels) == 1, [e.name() for e in kernels]
    k = kernels[0]
    a, b = rec.unix_ns(sp.start_ns), rec.unix_ns(sp.end_ns)
    k0, k1 = k.start_ns(), k.start_ns() + k.duration_ns()
    assert a - CLOCK_SLACK_NS <= k0 < k1 <= b + CLOCK_SLACK_NS, (a, k0, k1, b)
    assert abs(k0 - a) < 1_000_000
    # the span's own stream interval holds the kernel too (the anchor's
    # launch latency aside)
    assert sp.dev_start_ns <= sp.dev_end_ns
    assert rec.unix_ns(sp.dev_start_ns) - CLOCK_SLACK_NS <= k0
    assert k1 <= rec.unix_ns(sp.dev_end_ns) + CLOCK_SLACK_NS


@pytest.mark.gpu
@pytest.mark.parametrize("timed", [True, ("run", "step")])
@pytest.mark.parametrize("queue", sorted(QUEUES))
def test_device_times_and_kth_free_launches_on_the_card(queue, timed):
    _need_card()
    w = _workload()
    sched = _scheduler(queue, device="cuda")
    off = _fields(sched.run(w))
    k0 = kth_free_cuda.launches
    with trace.collect(device=timed) as rec:
        on = _fields(sched.run(w))
    assert rec.total("kth_free.calls") == kth_free_cuda.launches - k0
    for name, x in off.items():
        assert _same_bits(x, on[name]), name
    if timed is not True:
        assert all((s.dev_start_ns is None) == (s.name not in timed)
                   for s in rec.spans)
        return
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        assert s.dev_start_ns is not None and s.dev_start_ns <= s.dev_end_ns
        # the device reaches a span's work after the host enqueued it
        assert s.dev_start_ns >= s.start_ns - 200_000
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.dev_start_ns <= s.dev_start_ns
            assert s.dev_end_ns <= p.dev_end_ns
    steps = rec.named("step")
    assert all(a.dev_end_ns <= b.dev_start_ns
               for a, b in zip(steps, steps[1:]))
