"""Streaming service counters: one cheap fold per dispatcher step.

Everything here is plain python scalars — the metrics stream must stay
readable mid-session without touching device state, and a snapshot must
round-trip through the checkpoint metadata (msgpack) unchanged.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, fields


@dataclass
class ServiceMetrics:
    """Counters over one dispatcher session.

    Schema (the reference's ``docs/SERVICE.md``): step/submission/
    placement/finish/backfill counts, the current queue depth and clock,
    the running peak cluster draw and the draw at the last step, and
    decision latency (wall-clock of one ``step_once``, the step's launches
    and its one device-to-host copy included) as last / total / max —
    mean is derived, never stored.
    """
    n_steps: int = 0
    n_submitted: int = 0
    n_placed: int = 0
    n_finished: int = 0
    n_backfilled: int = 0
    queue_depth: int = 0
    now: float = 0.0
    peak_power: float = 0.0
    cluster_power: float = 0.0
    latency_us_last: float = 0.0
    latency_us_total: float = 0.0
    latency_us_max: float = 0.0

    def observe_submit(self):
        self.n_submitted += 1

    def observe_step(self, out: dict, dt_us: float):
        """Fold one step's decision record (numpy scalars) in."""
        self.n_steps += 1
        self.n_placed += int(out["placed"])
        self.n_finished += int(out["final"])
        self.n_backfilled += int(out["bf"]) if bool(out["final"]) else 0
        self.queue_depth = int(out["qlen"])
        self.now = float(out["now"])
        self.cluster_power = float(out["power"])
        self.peak_power = max(self.peak_power, self.cluster_power)
        self.latency_us_last = dt_us
        self.latency_us_total += dt_us
        self.latency_us_max = max(self.latency_us_max, dt_us)

    @property
    def mean_latency_us(self) -> float:
        return self.latency_us_total / max(self.n_steps, 1)

    def snapshot(self) -> dict:
        """All fields plus the derived mean — the record the CLI emits
        and the checkpoint stores."""
        return {**asdict(self), "mean_latency_us": self.mean_latency_us}

    @classmethod
    def from_snapshot(cls, d: dict) -> "ServiceMetrics":
        keep = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in keep})
