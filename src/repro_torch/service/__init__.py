"""Online scheduler service: the event core as a live decision engine.

``Dispatcher`` holds the event core's carry (node-free / power tables,
pending buffer, reservations) as long-lived state on the device: jobs are
submitted one at a time, the clock is driven through bounded horizons,
and every step emits the placement decision the batch run would have
made — bit-identically.  ``whatif`` forks the live carry into a rollout
for operator queries; ``ServiceMetrics`` streams queue / power / latency
counters; ``repro_torch.launch.scheduler_service`` is the JSONL CLI loop.
The reference's multi-session pool (``SessionPool``, ``AsyncWriter``) is
not ported (ROADMAP Queue 1 item 10b).
"""

from repro_torch.service.dispatcher import Dispatcher
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.whatif import whatif

__all__ = ["Dispatcher", "ServiceMetrics", "whatif"]
