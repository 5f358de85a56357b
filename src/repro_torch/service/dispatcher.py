"""Long-lived dispatcher: the event core's carry as live service state.

The batch run steps ``step(ctx, carry, horizon)`` over the whole job
stream; the dispatcher builds the SAME step (``live=True``, which adds
the live-decision channels) once and calls it per event, holding the
carry between calls.  Three operations drive a session:

  submit(prog, arrival)   register a job: write it into the next slot of
                          the capacity-padded job tensors in place (the
                          per-job draws of every slot are drawn once, at
                          construction; threefry is counter based);
  drive(until)            advance the clock through pushes / placements
                          / event hops, never past ``until`` (the step's
                          horizon gate) — returns the decisions emitted;
  drain()                 drive with an open horizon until quiescent.

Every ``step_once`` copies one row of the step's channels to the host
(``events.LIVE_COLS``), its one synchronisation; the per-job results stay
on the device in the batch run's ``_Record``.  Fed a workload's stream
submit-before-drive-past (each job submitted before the clock is driven
past its arrival), the decisions and ``result()`` are bit-identical to
``Scheduler(..., engine="events").run`` on the same device: the extra
quiescent steps a live session takes are no-ops on the carry, and the
session steps one lane, as the batch run of one point does.
``save``/``restore`` persist the carry, the job tensors and the record
through ``CheckpointManager`` (atomic npz + msgpack), so a killed session
resumes mid-stream with identical remaining decisions.
"""

from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.engine import (F32, FaultConfig, Scheduler, Workload,
                                     _fault_vec, _job_draws, _power_totals,
                                     _workload_arrays)
from repro_torch.core.events import (LIVE_COLS, _event_results, _Record,
                                     cons_carry0, event_carry0, event_context,
                                     make_cons_step, make_event_step)
from repro_torch.core.policy import BIG, Policy, _host
from repro_torch.core.result import SimResult
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.utils.tree import map_with_names

#: how each live channel reads on the host
_INTS = ("j_push", "qlen", "sys", "tier", "j_fin", "j_add")
_BOOLS = ("pushed", "placed", "final", "advanced", "bf")


def _host_record(row) -> dict:
    """One step's live row (a list of floats) as typed host scalars."""
    out = dict(zip(LIVE_COLS, row))
    for c in _INTS:
        out[c] = int(out[c])
    for c in _BOOLS:
        out[c] = bool(out[c])
    return out


def _point_lanes(pol: Policy, seed: int, fault, device) -> dict:
    """The one lane of a session, built as ``Scheduler.run`` builds a
    point's lanes."""
    leaf = lambda x: torch.as_tensor(_host(x)).to(F32).reshape(1)  # noqa: E731
    lanes = {"k": leaf(pol.k), "ucb_scale": leaf(pol.ucb_scale),
             "freq_weight": leaf(pol.freq_weight),
             "power_cap": leaf(pol.power_cap),
             "seed": torch.tensor([seed], dtype=torch.int32),
             "fvec": torch.tensor([_fault_vec(fault or FaultConfig())],
                                  dtype=F32)}
    return {n: x.to(device) for n, x in lanes.items()}


class Dispatcher:
    """A stateful scheduling session over one facility description.

    ``w`` supplies the program x system tables (runtimes, energies, node
    counts, idle watts, outages); its job stream is only a catalog — the
    session's jobs are whatever ``submit`` registers, up to ``capacity``
    (default: the catalog's length).

    Construction: ``Dispatcher.from_scheduler(sched, w, ...)`` is the
    one path — a configured batch ``Scheduler`` IS the session spec
    (policy with queue/cap/tier knobs applied, placer, fault model,
    seed, warm start, device), so the live session re-declares nothing.
    The keyword signature survives as a thin shim that builds the
    ``Scheduler`` for you (``device``: None = CUDA, raising without a
    card).  Policy leaves must be scalars (a grid has no live
    interpretation).  ``checkpoint_dir`` arms save/restore
    (``checkpoint_namespace`` sub-scopes it).
    """

    def __init__(self, w: Workload, policy: str | Policy = "paper", *,
                 capacity: int | None = None, seed: int = 0,
                 fault: FaultConfig | None = None, placer: str | None = None,
                 warm_start: bool = False, queue: str | None = None,
                 power_cap=None, checkpoint_dir: str | None = None,
                 keep_n: int = 3, device=None):
        sched = Scheduler(
            policy, placer=placer, faults=fault, seeds=int(seed),
            warm_start=warm_start, queue=queue, power_cap=power_cap,
            device=device)
        self._setup(sched, w, capacity=capacity,
                    checkpoint_dir=checkpoint_dir, keep_n=keep_n)

    @classmethod
    def from_scheduler(cls, sched: Scheduler, w: Workload, *,
                       capacity: int | None = None,
                       seed: int | None = None,
                       checkpoint_dir: str | None = None,
                       keep_n: int = 3,
                       checkpoint_namespace: str | None = None
                       ) -> "Dispatcher":
        """The single construction path (CLI, tests): adopt a batch
        ``Scheduler``'s full configuration as the live session spec.
        ``seed`` overrides the scheduler's scalar seed; grid-valued
        schedulers (seed/fault axes, leaf-batched policies) are rejected
        — a live session is one point."""
        self = cls.__new__(cls)
        self._setup(sched, w, capacity=capacity, seed=seed,
                    checkpoint_dir=checkpoint_dir, keep_n=keep_n,
                    checkpoint_namespace=checkpoint_namespace)
        return self

    def _setup(self, sched: Scheduler, w: Workload, *,
               capacity=None, seed=None, checkpoint_dir=None, keep_n=3,
               checkpoint_namespace=None):
        if isinstance(sched.faults, tuple):
            raise ValueError("live sessions take one FaultConfig, not a "
                             "fault grid")
        if not isinstance(sched.seeds, (int, np.integer)):
            raise ValueError("live sessions take one seed, not a grid")
        pol = sched.policy
        for leaf in ("k", "ucb_scale", "power_cap", "freq_weight"):
            if np.asarray(_host(getattr(pol, leaf))).ndim:
                raise ValueError(f"live policy leaf {leaf!r} must be a "
                                 "scalar, got a grid")
        self.scheduler = sched
        self.policy = pol
        self.seed = int(sched.seeds if seed is None else seed)
        self.fault = sched.faults
        self.placer = sched.placer
        self.warm_start = bool(sched.warm_start)
        self.device = sched.device
        self.capacity = int(capacity) if capacity else max(len(w.prog), 1)
        self.w = w
        self._retries = bool(self.fault and self.fault.failure_prob > 0)

        # the session's job stream: C slots, none submitted (prog 0,
        # arrival BIG, k NaN), one context and one draw of every slot
        C = self.capacity
        wc = replace(w, prog=np.zeros(C, np.int32),
                     arrival=np.full(C, BIG, np.float32),
                     k_job=np.full(C, np.nan, np.float32))
        arrs = _workload_arrays(wc, self.device)
        self._n_out = (arrs["outage"][..., 1].numel()
                       if "outage" in arrs else 0)
        ctx = event_context(arrs, wc, pol,
                            _point_lanes(pol, self.seed, self.fault,
                                         self.device),
                            self.warm_start, self.placer)
        ctx.update(_job_draws(ctx))
        self._ctx = ctx
        self._arrival_h = np.full(C, BIG, np.float32)

        cons = pol.queue == "conservative"
        self._step = (make_cons_step if cons else make_event_step)(
            pol, self.placer, totals_only=False, retries=self._retries,
            live=True)
        # live sessions open at t=0 (the batch run opens at the first
        # arrival; the extra advances to reach it are carry no-ops)
        self._carry = (cons_carry0 if cons else event_carry0)(
            ctx, False, now0=0.0)
        self._rec = _Record(1, C, self.device)
        self._now = 0.0

        self.n_submitted = 0
        self.metrics = ServiceMetrics()
        self.decisions: list[dict] = []
        self._mgr = (CheckpointManager(checkpoint_dir, keep_n=keep_n,
                                       namespace=checkpoint_namespace)
                     if checkpoint_dir else None)
        self._save_step = 0

    # ------------------------------------------------------------ intake
    def _validate_intake(self, prog: int, t: float, *, queued: int = 0,
                         last: float | None = None):
        """The submit-time checks, shared with the pool's buffered intake
        (``queued`` / ``last``: its not yet flushed jobs and the last
        one's arrival)."""
        if self.n_submitted + queued >= self.capacity:
            raise RuntimeError(f"session full: capacity {self.capacity}")
        if not 0 <= int(prog) < self.w.T_true.shape[0]:
            raise ValueError(f"prog {prog} not in the facility catalog "
                             f"(P={self.w.T_true.shape[0]})")
        if t < self.now:
            raise ValueError(f"arrival {t} is in the past (now={self.now})")
        if last is None and self.n_submitted:
            last = float(self._arrival_h[self.n_submitted - 1])
        if last is not None and t < last:
            raise ValueError("submissions must be arrival-ordered")

    def _write_job(self, ctx, j: int, prog: int, t: float, k):
        """In place: job ``j`` of the context ``ctx`` becomes (prog, t,
        k), its effective K column with it (``_job_draws``' rule).  Each
        write is a fill or a device copy: no host synchronisation (an
        item assignment would copy a host scalar to the card)."""
        ctx["prog"][j].fill_(int(prog))
        ctx["arrival"][j].fill_(t)
        ctx["kjob"][j].fill_(np.nan if k is None else float(k))
        ctx["K"][:, j].copy_(ctx["k"] if k is None else ctx["kjob"][j])

    def submit(self, prog: int, arrival: float | None = None,
               k: float | None = None) -> int:
        """Register a job: program index, submit time (default: the
        current clock), optional per-job K override.  Returns the job id.
        Submitting an arrival earlier than the clock is an error — the
        past is already decided."""
        t = float(self.now if arrival is None else arrival)
        self._validate_intake(prog, t)
        j = self.n_submitted
        self._write_job(self._ctx, j, prog, t, k)
        self._arrival_h[j] = t
        self.n_submitted += 1
        self.metrics.observe_submit()
        return j

    # ------------------------------------------------------------- clock
    @property
    def now(self) -> float:
        """The session clock, as of the last step (a host copy)."""
        return self._now

    def step_once(self, horizon: float = BIG) -> dict:
        """One event step under ``horizon``; returns the step's live
        channels as host scalars and folds them into the metrics."""
        t0 = time.perf_counter()
        self._carry, out = self._step(self._ctx, self._carry,
                                      float(np.float32(horizon)))
        self._rec.add(out)
        rec = _host_record(out["live"][0].tolist())   # the one sync
        self._fold(rec, (time.perf_counter() - t0) * 1e6)
        return rec

    def _fold(self, rec: dict, dt_us: float) -> None:
        """Fold one step's live row (``_host_record``) into the session:
        the clock, a final placement's decision, the metrics (``dt_us``:
        the step's wall time, or a pool step's share of it)."""
        self._now = rec["now"]
        if rec["final"] and rec["j_fin"] < self.capacity:
            self.decisions.append({
                "job": rec["j_fin"], "system": rec["sys"],
                "start": rec["s0"], "finish": rec["finish"],
                "wait": rec["wait"], "backfilled": rec["bf"],
                "tier": rec["tier"], "power": rec["power"],
                "now": rec["now"]})
        self.metrics.observe_step(rec, dt_us)

    def _budget(self) -> int:
        return 16 * self.capacity + self._n_out + 64

    def drive(self, until: float = BIG) -> list[dict]:
        """Step until quiescent under ``until``: no push, no placement,
        no clock advance.  Returns the placement decisions emitted."""
        n0 = len(self.decisions)
        for _ in range(self._budget()):
            out = self.step_once(until)
            if not (out["pushed"] or out["placed"] or out["advanced"]):
                break
        else:
            raise RuntimeError("drive() exceeded its step budget — the "
                               "carry is diverging (engine bug)")
        return self.decisions[n0:]

    def drain(self) -> list[dict]:
        """Run the session to completion (open horizon)."""
        return self.drive(BIG)

    # ------------------------------------------------------------ result
    def result(self) -> SimResult:
        """The realized session as a ``SimResult`` over the submitted
        jobs: the batch run's ``_event_results`` over the first n columns
        of the record, so a full session equals ``Scheduler.run``
        bitwise."""
        n = self.n_submitted
        ctx, carry = self._ctx, self._carry
        if n:
            out = _event_results({**ctx, "J": n, "prog": ctx["prog"][:n]},
                                 carry, self._rec)
        else:
            zero = torch.zeros(1, dtype=F32, device=self.device)
            empty = torch.zeros((1, 0), dtype=F32, device=self.device)
            out = {"system": empty.int(), "start": empty, "finish": empty,
                   "wait": empty, "energy": empty, "runtime": empty,
                   "nodes": empty.int(), "tier": empty.int(),
                   "backfilled": empty.bool(), "total_energy": zero,
                   "makespan": zero, "total_wait": zero, "max_wait": zero,
                   "slowdown_sum": zero, "busy": carry.busy,
                   **_power_totals(ctx["arrs"], zero, carry.busy,
                                   carry.peak, carry.cdel),
                   "C_tab": carry.CT[..., 0], "T_tab": carry.CT[..., 1],
                   "runs": carry.runs, "n_backfilled": carry.nbf}
        w = self.w
        # copies: the steps write the carry's tables in place
        return SimResult(**{k: v[0].clone() for k, v in out.items()},
                         axes=(),
                         n_jobs=n, n_nodes=np.asarray(w.n_nodes),
                         programs=w.programs, systems=w.systems,
                         freq_tiers=self.policy.freq_tiers)

    def carry_snapshot(self):
        """A host copy of the live carry (the steps write the carry in
        place, so this copies every leaf)."""
        return map_with_names(
            lambda _, x: x.detach().to("cpu", copy=True), self._carry)

    # -------------------------------------------------------- checkpoint
    def _tree(self):
        ctx, rec = self._ctx, self._rec
        return {"carry": self._carry,
                "jobs": {"prog": ctx["prog"], "arrival": ctx["arrival"],
                         "k_job": ctx["kjob"]},
                "perjob": {"E": rec.E, "sel_x": rec.sel_x,
                           "vals": rec.vals}}

    def save(self, blocking: bool = True) -> int:
        """Checkpoint the session (atomic; see checkpoint/manager.py; the
        tensors are copied before this returns).  Returns the checkpoint
        step id."""
        if self._mgr is None:
            raise RuntimeError("no checkpoint_dir configured")
        step = self._save_step
        self._mgr.save(step, self._tree(), metadata={
            "n_submitted": self.n_submitted,
            "decisions": self.decisions,
            "metrics": self.metrics.snapshot(),
        }, blocking=blocking)
        self._save_step = step + 1
        return step

    def restore(self, step: int | None = None) -> bool:
        """Restore the latest (or a specific) checkpoint into this
        session; returns False when the directory holds none.  The
        resumed session's remaining decisions are bit-identical to an
        uninterrupted run."""
        if self._mgr is None:
            raise RuntimeError("no checkpoint_dir configured")
        tree, step, meta = self._mgr.restore(self._tree(), step)
        if tree is None:
            return False
        self._carry = tree["carry"]
        ctx, jobs = self._ctx, tree["jobs"]
        for key, name in (("prog", "prog"), ("arrival", "arrival"),
                          ("kjob", "k_job")):
            ctx[key].copy_(jobs[name])
        ctx.update(_job_draws(ctx))
        for name in ("E", "sel_x", "vals"):
            getattr(self._rec, name).copy_(tree["perjob"][name])
        self._arrival_h = ctx["arrival"].cpu().numpy().copy()
        self._now = float(self._carry.now[0])
        self.n_submitted = int(meta["n_submitted"])
        self.decisions = list(meta["decisions"])
        self.metrics = ServiceMetrics.from_snapshot(meta["metrics"])
        self._save_step = step + 1
        return True

    def __repr__(self):
        return (f"Dispatcher(queue={self.policy.queue or 'fcfs'!r}, "
                f"jobs={self.n_submitted}/{self.capacity}, "
                f"now={self.now:.1f}, placed={len(self.decisions)})")
