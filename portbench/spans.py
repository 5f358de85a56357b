"""The span campaign of a ``--trace 1`` run on the card, and what its
readers compute from it.

After the harness's traced and sync-count campaigns, the first reader of
a span metric runs one more campaign of the stream's first ``trace_jobs``
jobs, on a fresh block of lane seeds, under the device-only profiler and
the port's tracer (``repro_torch.utils.trace.collect``), and keeps it in
``ctx["spans"]`` for the others: ``recording`` (the tracer's spans),
``trace`` (that campaign's ``measure.Trace``, with ``start_ns``: the
profiler trace's start, Unix-epoch ns, the clock of the tracer's
``wall_pair``) and ``steps``.  The window, the traced campaign and the
sync-count campaign run as before, with the tracer off.

The run's ``--seed`` is read from the command line (``run.py``'s), the
stream rebuilt from it through ``program.py``, and the lane seeds follow
the harness's blocks (``harness.seed_base``; block ``campaigns + 3``).
There is no span campaign, and each reader returns None, off the card,
without a ``--seed``, or where the port has no tracer (a checkout before
it).  The spans' idle gaps by host span (``idle_gaps_by_span``) go to
standard error, beside the harness's log.

Readers see spans as plain objects with ``name``, ``start_ns`` / ``end_ns``
(host, ``perf_counter_ns``) and ``dev_start_ns`` / ``dev_end_ns`` (the
stream's, on the same clock), and a recording as ``spans`` and
``wall_pair``, so the tests hand-make both.
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from portbench import generator, harness, measure, spec

ROOT = Path(__file__).resolve().parents[1]
#: the facade's spans (``Scheduler.run`` and its prologue and epilogue)
FACADE = "run"
#: the prologue's spans, whose stream time ``prologue_share`` sums
PROLOGUE = ("run.workload_arrays", "run.setup", "run.job_draws")
#: the label of an idle gap that begins while no span is open
NO_SPAN = "(no span open)"
#: the spans whose stream intervals the readers read; only these record
#: device events, so the tracer's host cost stays low where the host and
#: the device are near balance (the FCFS cell)
TIMED = ("run", *PROLOGUE, "step", "easy.trial")


@dataclass
class AlignedTrace(measure.Trace):
    """A ``measure.Trace`` and its start on the Unix clock (ns): an
    operation's interval is ``start_ns + 1e3 * us``."""
    start_ns: int = 0


def device_trace(fn) -> AlignedTrace:
    """``measure.device_trace`` keeping the profiler trace's absolute
    start (``kineto_results.trace_start_ns()``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    ops = sorted(((e.name, float(e.time_range.start),
                   float(e.time_range.end))
                  for e in prof.events() if e.device_type == cuda),
                 key=lambda op: op[1])
    return AlignedTrace(ops=ops, wall_s=wall,
                        start_ns=int(prof.profiler.kineto_results
                                     .trace_start_ns()))


def run_seed(argv=None):
    """The run's ``--seed`` on the benchmark's command line, or None."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int)
    args, _ = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    return args.seed


def record(ctx: dict, seed: int, device: str):
    """Run the span campaign of ``ctx``'s cell for run seed ``seed``;
    None where the port has no tracer."""
    try:
        from repro_torch.utils import trace
    except ImportError:
        return None
    from portbench import program
    config, own = ctx["config"], ctx["own"]
    cell = spec.cell(spec.load(ROOT), ROOT, ctx["cell"], True)
    w = program.prefix(program.build_workload(
        generator.generate(cell.traffic, seed), config),
        int(own["trace_jobs"]))
    R = int(own["seeds_per_campaign"])
    first = harness.seed_base(seed) + (ctx["campaigns"] + 3) * R
    sched = program.scheduler(config, range(first, first + R), device)
    held = {}

    def campaign():
        with trace.collect(device=TIMED) as rec:
            program.run(sched, w, config)
        held["rec"] = rec

    k0 = program.kth_launches()
    tr = device_trace(campaign)
    return {"recording": held["rec"], "trace": tr,
            "steps": harness.steps_per_campaign(config, len(w.prog)),
            "kth_launches": program.kth_launches() - k0}


def get(ctx: dict):
    """The span campaign of this run, run by the first reader that asks
    (on the card, in a ``--trace 1`` run), or None.  Logs its device
    operations a step, kth_free calls by span against the kernel's
    launches, and ``idle_gaps_by_span``."""
    if "spans" not in ctx:
        seed = run_seed()
        ctx["spans"] = got = (None if ctx["trace"] is None or seed is None
                              else record(ctx, seed, "cuda"))
        if got is not None:
            rec = got["recording"]
            log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
            tr = got["trace"]
            log(f"spans: {len(tr.ops) / got['steps']} device operations a "
                f"step, idle {100.0 * (1.0 - tr.busy_s() / tr.wall_s)}% of "
                f"{tr.wall_s} s; kth_free calls by span "
                f"{rec.by_span('kth_free.calls')}, kernel launches "
                f"{got['kth_launches']}")
            log(f"breakdown idle_gaps_by_span "
                f"{measure.top(idle_gaps_by_span(got))}")
    return ctx["spans"]


# what the readers compute


def stream_ns(span) -> int:
    """How long the stream took from a span's entry event to its exit
    event."""
    return span.dev_end_ns - span.dev_start_ns


def named(rec, name: str) -> list:
    return [s for s in rec.spans if s.name == name]


def is_facade(name: str) -> bool:
    return name == FACADE or name.startswith(FACADE + ".")


def idle_gaps(tr: AlignedTrace) -> list:
    """The device's idle intervals between operations, [(start, end)] in
    Unix-epoch ns."""
    out, end = [], None
    for _, a, b in tr.ops:
        if end is not None and a > end:
            out.append((tr.start_ns + round(1e3 * end),
                        tr.start_ns + round(1e3 * a)))
        end = b if end is None else max(end, b)
    return out


def innermost(spans, times) -> list:
    """The innermost host span open at each of ``times`` (ascending,
    ``perf_counter_ns``), or None.  Spans nest: a child lies inside its
    parent's host interval."""
    order = sorted(spans, key=lambda s: s.start_ns)
    out, stack, i = [], [], 0
    for t in times:
        while i < len(order) and order[i].start_ns <= t:
            s = order[i]
            i += 1
            while stack and stack[-1].end_ns <= s.start_ns:
                stack.pop()
            stack.append(s)
        while stack and stack[-1].end_ns <= t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def gaps_by_span(got: dict) -> list:
    """Each idle gap's seconds beside the innermost host span open at its
    start (None outside every span)."""
    rec, tr = got["recording"], got["trace"]
    gaps = idle_gaps(tr)
    offset = rec.wall_pair[1] - rec.wall_pair[0]      # Unix - perf
    at = innermost(rec.spans, [a - offset for a, _ in gaps])
    return [((b - a) * 1e-9, s) for (a, b), s in zip(gaps, at)]


def idle_gaps_by_span(got: dict) -> dict:
    """Idle seconds summed by the innermost host span open at each gap's
    start."""
    out: dict = {}
    for sec, s in gaps_by_span(got):
        name = NO_SPAN if s is None else s.name
        out[name] = out.get(name, 0.0) + sec
    return out
