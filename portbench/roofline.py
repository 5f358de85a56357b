"""The yardstick's peaks and byte counts.

Peaks are NVIDIA's H100 SXM 80GB datasheet figures at the full 700 W
(not measurements).  A kernel's least time is its logical bytes over the
HBM rate: each input byte counted once and each output byte once, a
table that many requests share counted once a call (not once a request),
so the count is the same whatever implements the call.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
HBM_BYTES = 80e9

F32 = 4
I32 = 4


def kth_free_call_bytes(tables: int, rows: int, nodes: int,
                        requests: int) -> int:
    """One kth-free call: ``tables`` node-free tables of ``rows`` x
    ``nodes`` f32 read once each, and ``requests`` selections, each an
    int32 count in and an f32 time out."""
    return tables * rows * nodes * F32 + requests * (I32 + F32)


def kth_free_step_bytes(queue: str, lanes: int, systems: int, nodes: int,
                        window: int = 0) -> int:
    """The kth-free bytes of one step of the arrival-indexed cores.

    FCFS: one call, each lane's [systems, nodes] table with one request a
    system.  Batched EASY: the shared call (each lane's table once, one
    request a system for each of the window + 1 slots) and the head
    recheck (each slot's trial row of the head's system, one request
    each)."""
    if queue == "fcfs":
        return kth_free_call_bytes(lanes, systems, nodes, lanes * systems)
    if queue == "easy_backfill":
        slots = window + 1
        return (kth_free_call_bytes(lanes, systems, nodes,
                                    lanes * slots * systems)
                + kth_free_call_bytes(lanes * slots, 1, nodes,
                                      lanes * slots))
    raise ValueError(f"no kth-free byte count for queue {queue!r}")


def least_seconds(nbytes: float) -> float:
    """The least time the card could move ``nbytes`` in."""
    return nbytes / HBM_BYTES_PER_S
