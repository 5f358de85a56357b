"""A run with the timed path broken underneath comes out not correct.

Each case drives the rest of a run on the CPU (the harness without its
look for a card, at a test's size) with one fault planted in the port's
engine: a step that leaves its state unchanged, half of the lanes left
out and filled with the mean of the rest, and one answer altered where
it is produced.  The exchange between cards is no fault a one-card cell
can have.  A run without a fault is correct."""

import time
from pathlib import Path

import pytest

from portbench import harness, spec

torch = pytest.importorskip("torch")
from repro_torch.core import engine  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
#: long enough that jobs queue, so a lost allocation moves the totals
SMALL = dict(seeds_per_campaign=2, jobs_per_campaign=150, warm_jobs=8)
#: the selector call altered: past the warm campaign's (at most 8 + 16)
ALTERED_CALL = 40


def _run(cell):
    torch.set_num_threads(1)
    c = spec.cell(BENCH, ROOT, cell, False)
    return harness.run_cell(c, 2 ** 31 + 77, 0.3, False, device="cpu",
                            t_process=time.perf_counter(), overrides=SMALL,
                            log=lambda s: None)


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(engine, "_alloc_row",
                        lambda row, kth_sel, need, finish: row)


def _half_left_out(monkeypatch):
    def wrap(core):
        def run(arrs, w, pol, lanes, **kw):
            B = lanes["k"].shape[0]
            h = B // 2
            out = core(arrs, w, pol, {n: x[:h] for n, x in lanes.items()},
                       **kw)
            fill = lambda x: x.double().mean(0, keepdim=True).to(  # noqa: E731
                x.dtype).expand((B - h,) + x.shape[1:])
            return {n: torch.cat([x, fill(x)]) for n, x in out.items()}
        return run
    monkeypatch.setattr(engine, "_arrival_run", wrap(engine._arrival_run))
    monkeypatch.setattr(engine, "_easy_run", wrap(engine._easy_run))


def _answer_altered(monkeypatch):
    def wrap(fn):
        calls = [0]

        def select(*a, **kw):
            sel = fn(*a, **kw)
            calls[0] += 1
            return (sel + 1) % 4 if calls[0] == ALTERED_CALL else sel
        return select
    monkeypatch.setattr(engine, "select", wrap(engine.select))
    monkeypatch.setattr(engine, "select_batched",
                        wrap(engine.select_batched))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = _run(cell)
    assert line["correct"] and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    line = _run(cell)
    assert not line["correct"]
    assert line["failed"] > 0
