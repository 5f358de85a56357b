"""Host spans and counters of the port, on one clock with the device.

Off by default.  Then ``span(name, **attrs)`` returns one shared null
context and ``count(name, n)`` returns at once, after one check of a
module flag: nothing is recorded, launched or synchronised, and every
result is bit-equal with the tracer on or off.

``collect(device=True)`` turns the tracer on for its body and yields a
``Recording``.  Each ``Span`` in it has an ``id``, a ``parent`` (the
innermost span open at its entry, or None), a ``name``, ``attrs``, host
``start_ns`` / ``end_ns`` from ``time.perf_counter_ns()``, and ``counts``:
the counters incremented while it was the innermost open span (counts
outside every span go to ``Recording.counts``).  Only the thread that
opened ``collect`` is recorded.

On a CUDA device (``device`` set and CUDA present) each span (or, with
``device`` a collection of names, each span of those names) also records
a ``torch.cuda.Event`` on the current stream at entry and at exit; when
``collect`` ends it synchronises once and turns them into ``dev_start_ns``
/ ``dev_end_ns`` on the host clock, through one anchor event recorded on
an empty stream right after a synchronise, beside a ``perf_counter_ns()``
reading.  ``dev_start_ns - start_ns`` is then how long the span's work
waited in the stream before the device reached it.  An event record is no
device operation the profiler reports (no kernel, copy or memset, and no
``record_function`` / NVTX range), and makes no host synchronisation.

Clocks.  Host times are ``time.perf_counter_ns()`` (CLOCK_MONOTONIC on
Linux).  ``Recording.wall_pair`` is one ``(perf_counter_ns(),
time.time_ns())`` pair taken together; ``Recording.unix_ns`` maps a host
time onto CLOCK_REALTIME, Unix-epoch nanoseconds.  That is the clock of the
torch profiler's Kineto events: ``profile.profiler.kineto_results
.trace_start_ns()`` and each event's ``start_ns()`` are Unix-epoch
nanoseconds, device activity included (CUPTI maps the device's timestamps
onto it, within about 0.2 ms; torch 2.11 exposes no clock function of its
own), checked on an H100 by ``tests/test_torch_trace.py``'s ``gpu`` cases.

``Recording.chrome_trace()`` gives the spans as Chrome-trace JSON (host
spans on one track, their stream intervals on another), in microseconds
of the Unix epoch, so the file lines up with a profiler trace.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time

import torch

#: the recording in progress, None when the tracer is off
_rec = None


class _Null:
    """The shared context every span gives while the tracer is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _record():
    """A timing event recorded on the current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Span:
    """One host interval (and, on the card, its stream interval)."""

    __slots__ = ("id", "parent", "name", "attrs", "start_ns", "end_ns",
                 "counts", "dev_start_ns", "dev_end_ns", "_rec", "_events")

    def __init__(self, rec, name: str, attrs: dict):
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self.counts: dict = {}
        self.end_ns = self.dev_start_ns = self.dev_end_ns = None

    def __enter__(self):
        rec = self._rec
        stack = rec._stack
        self.id = len(rec.spans)
        self.parent = stack[-1].id if stack else None
        rec.spans.append(self)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        timed = rec.device and (rec.names is None or self.name in rec.names)
        self._events = [_record()] if timed else None
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events.append(_record())
        self.end_ns = time.perf_counter_ns()
        self._rec._stack.pop()
        return False


class Recording:
    """The spans and counts of one ``collect``."""

    def __init__(self, device: bool, names=None):
        self.spans: list = []
        self.counts: dict = {}
        self.device = device
        self.names = names
        self.thread = threading.get_ident()
        self.wall_pair = (time.perf_counter_ns(), time.time_ns())
        self._stack: list = []
        self._anchor = None

    def _count(self, name: str, n: int) -> None:
        into = self._stack[-1].counts if self._stack else self.counts
        into[name] = into.get(name, 0) + n

    def _start_device(self) -> None:
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter_ns()
        ev.record()
        self._anchor = (t, ev)

    def _finish_device(self) -> None:
        torch.cuda.synchronize()
        t0, anchor = self._anchor
        for s in self.spans:
            if s._events is not None and len(s._events) == 2:
                a, b = (t0 + round(anchor.elapsed_time(e) * 1e6)
                        for e in s._events)
                s.dev_start_ns, s.dev_end_ns = a, b
            s._events = None
        self._anchor = None

    # reading

    def unix_ns(self, perf_ns: int) -> int:
        """A host time (``perf_counter_ns``) on the Unix-epoch clock of the
        profiler's events."""
        return perf_ns + self.wall_pair[1] - self.wall_pair[0]

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def total(self, counter: str) -> int:
        """``counter`` summed over every span and outside them."""
        return (self.counts.get(counter, 0)
                + sum(s.counts.get(counter, 0) for s in self.spans))

    def by_span(self, counter: str) -> dict:
        """``counter`` by the name of the innermost span it was counted
        in: its call sites."""
        out: dict = {}
        for s in self.spans:
            if counter in s.counts:
                out[s.name] = out.get(s.name, 0) + s.counts[counter]
        return out

    def chrome_trace(self) -> dict:
        """Chrome-trace JSON: host spans on track ``host``, stream
        intervals on track ``stream``; microseconds of the Unix epoch."""
        us = lambda ns: self.unix_ns(ns) / 1e3  # noqa: E731
        events = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                   "args": {"name": label}}
                  for tid, label in ((0, "host"), (1, "stream"))]
        for s in self.spans:
            args = {"id": s.id, "parent": s.parent, **s.attrs, **s.counts}
            if s.end_ns is not None:
                events.append({"name": s.name, "ph": "X", "pid": 0, "tid": 0,
                               "ts": us(s.start_ns),
                               "dur": (s.end_ns - s.start_ns) / 1e3,
                               "args": args})
            if s.dev_start_ns is not None:
                events.append({"name": s.name, "ph": "X", "pid": 0, "tid": 1,
                               "ts": us(s.dev_start_ns),
                               "dur": (s.dev_end_ns - s.dev_start_ns) / 1e3,
                               "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"counts_outside_spans": self.counts}}

    def write_chrome_trace(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


def span(name: str, **attrs):
    """A context that records one span while the tracer is on."""
    rec = _rec
    if rec is None:
        return _NULL
    if threading.get_ident() != rec.thread:
        return _NULL
    return Span(rec, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` in the innermost open span."""
    rec = _rec
    if rec is None:
        return
    if threading.get_ident() == rec.thread:
        rec._count(name, n)


@contextlib.contextmanager
def collect(device=True):
    """Turn the tracer on for the body; yields the ``Recording``, whose
    device times are filled in when the body ends (one synchronise).
    ``device``: True (every span's stream interval, on a CUDA device),
    False, or the names of the spans to time on the stream (each event
    record costs the host a few microseconds)."""
    global _rec
    if _rec is not None:
        raise RuntimeError("trace.collect is already open")
    names = None if isinstance(device, bool) else frozenset(device)
    rec = Recording(bool(device) and torch.cuda.is_available(), names)
    if rec.device:
        rec._start_device()
    _rec = rec
    try:
        yield rec
    finally:
        _rec = None
        if rec.device:
            rec._finish_device()
