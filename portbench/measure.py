"""Device traces and host synchronisations of one call, for the per-layer
readers.

``device_trace`` profiles the device alone (CUDA activity; host events
would triple what is read back, at ~0.3 ms an event) around a call that
ends synchronised, and keeps each device operation's name and interval.
``sync_count`` counts the call's host synchronisations with PyTorch's
sync debug mode.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass


@dataclass
class Trace:
    """Device operations of one traced call: ``ops`` [(name, start_us,
    end_us)] sorted by start, and the call's host wall seconds."""
    ops: list
    wall_s: float

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union of the
        operations' intervals)."""
        busy, end = 0.0, None
        for _, a, b in self.ops:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy * 1e-6

    def seconds_by_name(self, match=None) -> dict:
        """Device seconds per operation name (those whose name contains
        one of ``match``, when given)."""
        out: dict = {}
        for name, a, b in self.ops:
            if match is None or any(m in name for m in match):
                out[name] = out.get(name, 0.0) + (b - a) * 1e-6
        return out

    def idle_gaps(self) -> dict:
        """Device idle seconds between operations, by the operation that
        ends each gap: what the host was launching while the device
        waited."""
        out: dict = {}
        end = None
        for name, a, b in self.ops:
            if end is not None and a > end:
                out[name] = out.get(name, 0.0) + (a - end) * 1e-6
            end = b if end is None else max(end, b)
        return out


def device_trace(fn) -> Trace:
    """``fn()`` under a device-only profiler, synchronised at its end."""
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
    return Trace(ops=ops, wall_s=wall)


def sync_count(fn) -> int:
    """Host synchronisations ``fn()`` makes, by PyTorch's sync debug mode
    (the one-time notice that the mode is a prototype not counted)."""
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(c.message) for c in caught)


def top(pairs: dict, n: int = 10, width: int = 160) -> list:
    """The ``n`` largest (name, seconds) entries, largest first, each name
    cut to its first ``width`` characters (kernel names carry their whole
    template arguments)."""
    return [[k[:width], v] for k, v in
            sorted(pairs.items(), key=lambda kv: -kv[1])[:n]]
