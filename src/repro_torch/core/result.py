"""Structured simulation results with named axes and derived metrics.

``SimResult`` wraps one simulation's outputs; ``CampaignResult`` is the
same with leading named axes (any of ``fault``/``policy``/``seed``) plus
the grid coordinates they index.  Every array field is a torch tensor on
the device the run used and carries the leading axes, so
``res.total_energy[f, g, r]`` and ``res.system[f, g, r, j]`` line up.

Derived metrics:
  mean_slowdown   mean over jobs of (wait + runtime) / runtime
  mean_wait       total_wait / n_jobs
  utilization     per-system busy node-seconds / (nodes * makespan)
  backfill_rate   fraction of jobs placed out of arrival order (0 here)
  tier_counts     placements per DVFS tier
  tier_energy     job-attributed energy per DVFS tier

Per-job fields are ``None`` on results produced with ``totals_only``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np
import torch

#: Fields carrying only the leading (grid) axes.
_TOTAL_FIELDS = ("total_energy", "makespan", "total_wait", "slowdown_sum",
                 "max_wait", "n_backfilled",
                 "peak_power", "idle_energy", "capped_delay")
#: Fields with a trailing per-job axis [..., J]; None if totals_only.
_PERJOB_FIELDS = ("system", "start", "finish", "wait", "energy", "runtime",
                  "nodes", "backfilled", "tier")
#: Learned-table fields [..., P, S] and the per-system busy field [..., S].
_TABLE_FIELDS = ("C_tab", "T_tab", "runs", "busy")


@dataclass(frozen=True)
class SimResult:
    """One simulation run (``axes == ()``) or a stacked grid of them."""
    total_energy: torch.Tensor
    makespan: torch.Tensor
    total_wait: torch.Tensor
    slowdown_sum: torch.Tensor
    busy: torch.Tensor
    C_tab: torch.Tensor
    T_tab: torch.Tensor
    runs: torch.Tensor
    max_wait: torch.Tensor | None = None
    n_backfilled: torch.Tensor | None = None
    peak_power: torch.Tensor | None = None
    idle_energy: torch.Tensor | None = None
    capped_delay: torch.Tensor | None = None
    system: torch.Tensor | None = None
    start: torch.Tensor | None = None
    finish: torch.Tensor | None = None
    wait: torch.Tensor | None = None
    energy: torch.Tensor | None = None
    runtime: torch.Tensor | None = None
    nodes: torch.Tensor | None = None
    backfilled: torch.Tensor | None = None
    tier: torch.Tensor | None = None
    axes: tuple = ()
    n_jobs: int = 0
    n_nodes: np.ndarray | None = None        # [S]
    programs: tuple = ()
    systems: tuple = ()
    freq_tiers: tuple = (1.0,)

    @property
    def totals_only(self) -> bool:
        return self.system is None

    @property
    def mean_wait(self):
        return self.total_wait / max(self.n_jobs, 1)

    @property
    def mean_slowdown(self):
        """Mean over jobs of (wait + runtime) / runtime; 1.0 = no queueing."""
        return self.slowdown_sum / max(self.n_jobs, 1)

    @property
    def utilization(self):
        """Per-system busy node-seconds / (node count x makespan),
        [*axes, S]."""
        nodes = torch.as_tensor(self.n_nodes, device=self.busy.device)
        return self.busy / (nodes * self.makespan.unsqueeze(-1))

    @property
    def backfill_rate(self):
        """Fraction of jobs placed out of arrival order; 0 under fcfs."""
        if self.n_backfilled is None:
            return None
        return self.n_backfilled / max(self.n_jobs, 1)

    def _tier_onehot(self):
        F = len(self.freq_tiers)
        return self.tier.unsqueeze(-1) == torch.arange(
            F, device=self.tier.device)

    @property
    def tier_counts(self):
        """Placements per frequency tier [*axes, F]; None if totals_only."""
        if self.tier is None:
            return None
        return self._tier_onehot().sum(-2)

    @property
    def tier_energy(self):
        """Job-attributed energy per frequency tier [*axes, F]."""
        if self.tier is None:
            return None
        onehot = self._tier_onehot().to(self.energy.dtype)
        return (self.energy.unsqueeze(-1) * onehot).sum(-2)

    def to_dict(self, arrays: bool = True) -> dict:
        """Flatten to a plain dict of totals, derived metrics and (with
        ``arrays``) the table and per-job fields."""
        out = {k: getattr(self, k) for k in _TOTAL_FIELDS
               if getattr(self, k) is not None}
        out["mean_wait"] = self.mean_wait
        out["mean_slowdown"] = self.mean_slowdown
        out["utilization"] = self.utilization
        if self.backfill_rate is not None:
            out["backfill_rate"] = self.backfill_rate
        if self.tier_counts is not None:
            out["tier_counts"] = self.tier_counts
            out["tier_energy"] = self.tier_energy
        if arrays:
            for k in _TABLE_FIELDS:
                out[k] = getattr(self, k)
            for k in _PERJOB_FIELDS:
                if getattr(self, k) is not None:
                    out[k] = getattr(self, k)
        return out

    def __repr__(self):
        ax = ",".join(self.axes) if self.axes else "scalar"
        kind = "totals" if self.totals_only else "full"
        return (f"{type(self).__name__}(axes=[{ax}], jobs={self.n_jobs}, "
                f"{kind})")


@dataclass(frozen=True, repr=False)
class CampaignResult(SimResult):
    """A grid of simulations with named leading axes and their coordinates:
    ``fault`` -> the FaultConfig tuple, ``policy`` -> the leaf-batched
    Policy, ``seed`` -> the seed tuple."""
    coords: dict = field(default_factory=dict)

    def index(self, **sel) -> "SimResult":
        """Select one point per named axis, e.g. ``res.index(policy=3,
        seed=0)``; axes not named are kept."""
        bad = set(sel) - set(self.axes)
        if bad:
            raise KeyError(f"unknown axes {sorted(bad)}; have {self.axes}")
        not_int = {a: v for a, v in sel.items()
                   if not isinstance(v, (int, np.integer))}
        if not_int:
            raise TypeError(f"index() takes integer points, got {not_int}; "
                            "slice arrays directly for ranges")
        idx = tuple(int(sel[a]) if a in sel else slice(None)
                    for a in self.axes)
        kept = tuple(a for a in self.axes if a not in sel)
        kw = {}
        for f in fields(SimResult):
            v = getattr(self, f.name)
            kw[f.name] = v[idx] if (f.name in _TOTAL_FIELDS + _PERJOB_FIELDS
                                    + _TABLE_FIELDS and v is not None) else v
        kw["axes"] = kept
        if kept:
            coords = {a: v for a, v in self.coords.items() if a in kept}
            return CampaignResult(coords=coords, **kw)
        return SimResult(**kw)
