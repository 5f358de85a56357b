"""The span metrics' readers (``portbench/spans.py``, ``metrics/``) on
hand-made recordings and traces, the span campaign's plumbing on the CPU
at a tiny size, and the existing readers unchanged beside them."""

from types import SimpleNamespace as NS

import pytest

from portbench import harness, measure, spans, spec

#: perf_counter_ns 0 is Unix-epoch ns 1e18 in the hand-made recordings
UNIX0 = 10 ** 18
SPAN_METRICS = ("stream_wait_us_per_step", "prologue_share",
                "facade_idle_share", "easy_trial_share")
OLD_METRICS = ("host_syncs_per_run", "launches_per_step",
               "device_us_per_step", "backfill_share",
               "kth_free_calls_per_step", "kth_free_roofline_share",
               "idle_share", "lane_jobs_per_s", "peak_mem_gib", "setup_s")


def _span(name, start, end, dev_start, dev_end):
    """A span in microseconds (host, then stream)."""
    us = lambda x: int(x * 1000)  # noqa: E731
    return NS(name=name, start_ns=us(start), end_ns=us(end),
              dev_start_ns=us(dev_start), dev_end_ns=us(dev_end))


def _recording():
    """One EASY-like campaign: run [0, 100] host, [5, 160] stream; the
    prologue, then two steps with their trial phases, then the results."""
    return NS(wall_pair=(0, UNIX0), spans=[
        _span("run", 0, 100, 5, 160),
        _span("run.workload_arrays", 1, 10, 5, 12),
        _span("run.setup", 10, 15, 12, 20),
        _span("run.job_draws", 15, 20, 20, 30),
        _span("run.steps", 20, 80, 30, 150),
        _span("step", 20, 40, 30, 90),
        _span("easy.trial", 25, 30, 40, 55),
        _span("step", 40, 60, 90, 150),
        _span("easy.trial", 45, 50, 100, 130),
        _span("run.results", 80, 90, 150, 155),
    ])


def _trace():
    """Device operations (us after the trace's start, which is host time
    0): idle gaps [12, 14] (in run.setup), [17, 21] (in run.job_draws),
    [45, 48] (in easy.trial), [95, 99] (in run), [120, 125] (no span
    open)."""
    ops = [("a", 5.0, 12.0), ("b", 14.0, 17.0), ("c", 21.0, 45.0),
           ("d", 48.0, 95.0), ("e", 99.0, 120.0), ("f", 125.0, 160.0)]
    return spans.AlignedTrace(ops=ops, wall_s=160e-6, start_ns=UNIX0)


def _ctx(queue="easy_backfill", trace=True):
    tr = measure.Trace(ops=[("add", 0.0, 1.0)], wall_s=2e-6)
    ctx = dict(cell="x", config={}, own={}, queue=queue, window=16,
               lanes=1000, systems=4, nodes=136, jobs=10, campaigns=2,
               wall_s=2.0, setup_s=3.0, lane_jobs=20000,
               peak_bytes=2 ** 31, window_steps=20, kth_launches=20,
               n_backfilled=5, trace=tr if trace else None, trace_steps=10,
               trace_kth_launches=10, syncs=7)
    if trace:
        ctx["spans"] = {"recording": _recording(), "trace": _trace(),
                        "steps": 2, "kth_launches": 4}
    return ctx


def test_innermost_open_span():
    rec = _recording()
    at = spans.innermost(rec.spans, [0, 12_000, 26_000, 40_000, 85_000,
                                     95_000, 120_000])
    assert [None if s is None else s.name for s in at] == [
        "run", "run.setup", "easy.trial", "step", "run.results", "run",
        None]


def test_idle_gaps_by_span():
    got = _ctx()["spans"]
    assert spans.idle_gaps(got["trace"]) == [
        (UNIX0 + a * 1000, UNIX0 + b * 1000)
        for a, b in ((12, 14), (17, 21), (45, 48), (95, 99), (120, 125))]
    assert spans.idle_gaps_by_span(got) == pytest.approx({
        "run.setup": 2e-6, "run.job_draws": 4e-6, "easy.trial": 3e-6,
        "run": 4e-6, spans.NO_SPAN: 5e-6})


def test_span_readers_hand_computed():
    ctx = _ctx()
    read = {m: spec.reader(m)(ctx) for m in SPAN_METRICS}
    # steps wait 10 and 50 us: the median 30
    assert read["stream_wait_us_per_step"] == pytest.approx(30.0)
    # prologue stream 7 + 8 + 10 us of run's 155
    assert read["prologue_share"] == pytest.approx(100 * 25 / 155)
    # facade gaps 2 + 4 + 4 us (not easy.trial's, not the one after run)
    # over run's 100 us of host wall
    assert read["facade_idle_share"] == pytest.approx(10.0)
    # trial stream 15 + 30 us of the steps' 60 + 60
    assert read["easy_trial_share"] == pytest.approx(100 * 45 / 120)


def test_span_readers_find_nothing_off_the_card_or_outside_their_cells():
    for m in SPAN_METRICS:
        assert spec.reader(m)(_ctx(trace=False)) is None
    ctx = _ctx(queue="fcfs")
    assert spec.reader("easy_trial_share")(ctx) is None
    assert spec.reader("stream_wait_us_per_step")(ctx) == pytest.approx(30.0)
    # a recording without one campaign's run span gives no share
    ctx["spans"]["recording"].spans.append(_span("run", 200, 300, 200, 300))
    assert spec.reader("prologue_share")(ctx) is None
    assert spec.reader("facade_idle_share")(ctx) is None


def test_existing_readers_unchanged_beside_the_spans():
    before = _ctx()
    del before["spans"]
    old = {m: spec.reader(m)(before) for m in OLD_METRICS}
    after = _ctx()
    for m in SPAN_METRICS:
        spec.reader(m)(after)
    assert {m: spec.reader(m)(after) for m in OLD_METRICS} == old


def test_run_seed_from_the_command_line():
    argv = ["--workload", "c", "--seed", "2147483659", "--seconds", "1",
            "--trace", "1"]
    assert spans.run_seed(argv) == 2147483659
    assert spans.run_seed(["-q", "tests"]) is None


def test_span_campaign_plumbing_on_the_cpu(monkeypatch):
    """``record`` at a tiny size on the CPU (the profiler replaced by a
    plain call): the tracer's one campaign of trace_jobs jobs over the
    next block of lane seeds, kth_free counted in its step phases."""
    pytest.importorskip("torch")
    from portbench import program
    monkeypatch.setattr(spans, "device_trace", lambda fn: (
        fn(), spans.AlignedTrace(ops=[], wall_s=0.0, start_ns=0))[1])
    seen = {}
    real = program.scheduler

    def scheduler(config, seeds, device):
        seen["seeds"] = list(seeds)
        return real(config, seeds, device)
    monkeypatch.setattr(program, "scheduler", scheduler)
    bench = spec.load(spans.ROOT)
    cell = spec.cell(bench, spans.ROOT, "easy16.swf-contended", True)
    own = {**cell.own, "trace_jobs": 6, "seeds_per_campaign": 2}
    ctx = dict(cell=cell.name, config=cell.config, own=own, campaigns=3)
    got = spans.record(ctx, 11, "cpu")
    base = harness.seed_base(11)
    assert seen["seeds"] == [base + 6 * 2, base + 6 * 2 + 1]
    rec = got["recording"]
    assert got["steps"] == 6 + 16 and len(spans.named(rec, "step")) == 22
    assert [s.name for s in rec.spans if s.parent is None] == ["run"]
    assert rec.by_span("kth_free.calls") == {"easy.score": 22,
                                             "easy.recheck": 22}
