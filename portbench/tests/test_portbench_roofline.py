"""The kth-free byte count from shapes, and the readers on a made-up
trace."""

import pytest

from portbench import measure, roofline, spec


def test_shared_table_counts_once_a_call():
    one = roofline.kth_free_call_bytes(tables=10, rows=4, nodes=136,
                                       requests=10 * 17 * 4)
    # the same table read by 17 requests a row counts once, not 17 times
    assert one == 10 * 4 * 136 * 4 + 10 * 17 * 4 * 8
    per_slot = roofline.kth_free_call_bytes(10 * 17, 4, 136, 10 * 17 * 4)
    assert per_slot > one


def test_step_bytes():
    B, S, N, W = 100, 4, 136, 16
    assert roofline.kth_free_step_bytes("fcfs", B, S, N) == (
        B * S * N * 4 + B * S * 8)
    assert roofline.kth_free_step_bytes("easy_backfill", B, S, N, W) == (
        B * S * N * 4 + B * (W + 1) * S * 8
        + B * (W + 1) * N * 4 + B * (W + 1) * 8)
    with pytest.raises(ValueError):
        roofline.kth_free_step_bytes("conservative", B, S, N)


def _ctx(trace):
    return dict(config={}, queue="fcfs", window=0, lanes=1000, systems=4,
                nodes=136, jobs=10, campaigns=2, wall_s=2.0, setup_s=3.0,
                lane_jobs=20000, peak_bytes=2 ** 31, window_steps=20,
                kth_launches=20, n_backfilled=0, trace=trace,
                trace_steps=10, trace_kth_launches=10, syncs=7)


def test_trace_union_gaps_and_readers():
    ops = [("kth_free_rank(float)", 0.0, 10.0), ("add", 5.0, 20.0),
           ("kth_free_rank(float)", 30.0, 40.0), ("mul", 45.0, 50.0)]
    tr = measure.Trace(ops=ops, wall_s=100e-6)
    assert tr.busy_s() == pytest.approx(35e-6)
    assert tr.idle_gaps() == pytest.approx({"kth_free_rank(float)": 10e-6,
                                            "mul": 5e-6})
    ctx = _ctx(tr)
    assert spec.reader("idle_share")(ctx) == pytest.approx(65.0)
    assert spec.reader("launches_per_step")(ctx) == pytest.approx(0.4)
    assert spec.reader("device_us_per_step")(ctx) == pytest.approx(3.5)
    share = spec.reader("kth_free_roofline_share")(ctx)
    want = (10 * roofline.kth_free_step_bytes("fcfs", 1000, 4, 136)
            / roofline.HBM_BYTES_PER_S / 20e-6 * 100)
    assert share == pytest.approx(want)
    assert spec.reader("kth_free_calls_per_step")(ctx) == 1.0
    assert spec.reader("host_syncs_per_run")(ctx) == 7
    assert spec.reader("lane_jobs_per_s")(ctx) == 10000.0
    assert spec.reader("peak_mem_gib")(ctx) == 2.0
    assert spec.reader("backfill_share")(ctx) is None


def test_readers_find_nothing_without_a_trace():
    ctx = _ctx(None)
    for name in ("idle_share", "launches_per_step", "device_us_per_step",
                 "kth_free_roofline_share"):
        assert spec.reader(name)(ctx) is None
    ctx["trace"] = measure.Trace(ops=[("add", 0.0, 1.0)], wall_s=1e-3)
    assert spec.reader("kth_free_roofline_share")(ctx) is None
