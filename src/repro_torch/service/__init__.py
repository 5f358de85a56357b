"""Online scheduler service: the event core as a live decision engine.

``Dispatcher`` holds the event core's carry (node-free / power tables,
pending buffer, reservations) as long-lived state on the device: jobs are
submitted one at a time, the clock is driven through bounded horizons,
and every step emits the placement decision the batch run would have
made — bit-identically.  ``SessionPool`` scales that out: N sessions as
the lanes of one stacked carry advanced by one batched step, with
batched intake and an ``AsyncWriter`` thread for decision records and
checkpoints.  ``whatif`` forks the live carry into a rollout for
operator queries; ``ServiceMetrics`` streams queue / power / latency
counters; ``repro_torch.launch.scheduler_service`` is the JSONL CLI loop
(one session, or ``--pool N``).
"""

from repro_torch.service.dispatcher import Dispatcher
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.pool import SessionPool
from repro_torch.service.whatif import whatif
from repro_torch.service.writer import AsyncWriter

__all__ = ["AsyncWriter", "Dispatcher", "ServiceMetrics", "SessionPool",
           "whatif"]
