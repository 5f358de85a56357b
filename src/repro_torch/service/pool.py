"""Multi-session scale-out: N facility sessions, ONE batched step.

``SessionPool`` holds N concurrent ``Dispatcher`` sessions as the N lanes
of one stacked carry and advances all of them with one call of the event
step (or the conservative step) with ``live=True`` at B = N.  The pool
builds that step once, at construction: sessions may differ only in
policy LEAVES (K, power cap, frequency weight, UCB scale) and in their
seed and fault vector, never in static composition (queue discipline,
window, tier grid, placer, retry mode, capacity, warm start); a session
that would need another step is refused there.  The step fuses its
multiply-adds as the reference's pool does (the context's ``site_lanes``
None, ``events._fusions``), which is not always as one session does: a
faulted session's learned tables can differ in an ulp from an
independent session's, in the reference as in the port.

Each lane reads its own job stream ([N, C] ``prog`` / ``arrival`` /
``kjob`` on the device) and its own horizon ([N]).  Intake is BATCHED:
``submit`` validates and buffers per session, and the buffer is written
into the stacked job tensors in one scatter per channel when that
session is next driven (``drive`` / ``drain``) or read (``result`` /
``whatif`` / ``save``).  Lanes not being driven hold their last horizon
and their job tensors, so their steps are no-ops on the carry: each
session's decisions and ``result()`` are bit-identical to the reference
pool's lane (``tests/test_torch_service_pool.py``), and to an independent
``Dispatcher`` fed the same stream wherever the fused sites agree (no
stragglers, or EASY with or without them).
A pool step makes one host synchronisation, one ``.tolist()`` of the
[N, len(LIVE_COLS)] live rows; ``submit`` makes none.

A member session's job tensors and per-job record are views of its lane
(the flush and the steps write them in place); its carry is read as a
copy of the lane and written back into the lane, so ``result()``,
``whatif``, ``carry_snapshot`` and ``save`` each copy their lane at the
moment of the call, and restoring one session writes only its lane.

Decision records and non-blocking checkpoints flow through one
``AsyncWriter`` thread (bounded queue, drained on close), so intake never
waits on disk.  Checkpoints are namespaced per session (``s000``,
``s001``, ...) under one ``checkpoint_dir`` root; ``restore`` brings any
or all sessions back bit-identically.
"""

from __future__ import annotations

import json
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.core.engine import (Scheduler, Workload, _job_draws,
                                     index_session, stack_sessions)
from repro_torch.core.events import (_Record, event_context, make_cons_step,
                                     make_event_step)
from repro_torch.core.policy import BIG
from repro_torch.service.dispatcher import (Dispatcher, _host_record,
                                            _point_lanes)
from repro_torch.service.whatif import whatif as _whatif
from repro_torch.service.writer import AsyncWriter
from repro_torch.utils.tree import flatten_with_names, map_with_names

#: the policy fields one pool step is built for; only the leaves (k,
#: ucb_scale, power_cap, freq_weight) may differ between sessions
_STATIC = ("exploration", "feasibility", "objective", "name", "queue",
           "window", "freq_tiers")
#: the per-lane job tensors of a context, written at flush
_STREAM = ("prog", "arrival", "kjob")


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device`` with no host synchronisation: on the
    card through pinned memory, asynchronously (the caching host
    allocator keeps the buffer until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _Member(Dispatcher):
    """One session of a pool: a ``Dispatcher`` whose job tensors, effective
    K and per-job record are views of lane ``_lane`` of the pool's stacked
    tensors, and whose carry is that lane (read as a copy, written into
    the lane).  Unbound (``_pool`` None, during construction) it keeps
    its own carry."""

    _pool = None

    @property
    def _carry(self):
        if self._pool is None:
            return self.__dict__["_carry"]
        return index_session(self._pool._carry, self._lane)

    @_carry.setter
    def _carry(self, carry):
        if self._pool is None:
            self.__dict__["_carry"] = carry
            return
        lane = self._lane
        new = dict(flatten_with_names(carry))
        for name, x in flatten_with_names(self._pool._carry):
            x[lane:lane + 1].copy_(new[name])

    def _bind(self, pool: "SessionPool", lane: int) -> None:
        """Make the session lane ``lane`` of ``pool`` (its carry already
        stacked there): its job stream the lane's row ([C], as a
        session's), its K and record the lane's one-lane slices."""
        self.__dict__.pop("_carry", None)
        self._pool, self._lane = pool, lane
        self._rec = pool._rec.lane(lane)
        for key in _STREAM:
            self._ctx[key] = pool._ctx[key][lane]
        self._ctx["K"] = pool._ctx["K"][lane:lane + 1]


def _static(pol) -> tuple:
    return tuple(getattr(pol, f) for f in _STATIC)


class SessionPool:
    """N live scheduling sessions advanced by one batched step.

    ``scheds`` is one batch ``Scheduler`` per session (the spec
    ``Dispatcher.from_scheduler`` adopts); all must share one static
    composition (queue discipline, window, placer, tier grid, retry mode,
    capacity, warm start, device), while leaves (K, power cap, frequency
    weight, UCB scale), seeds and fault vectors may differ.
    ``decision_log`` arms an append-only JSONL sink (``{"session": i,
    ...decision}`` per line) written by the async writer thread.
    """

    def __init__(self, scheds, w: Workload, *, capacity: int | None = None,
                 checkpoint_dir: str | None = None, keep_n: int = 3,
                 decision_log: str | None = None, writer_queue: int = 256):
        scheds = list(scheds)
        if not scheds:
            raise ValueError("a pool needs at least one session")
        self.w = w
        self.sessions = [
            _Member.from_scheduler(
                s, w, capacity=capacity, checkpoint_dir=checkpoint_dir,
                keep_n=keep_n, checkpoint_namespace=f"s{i:03d}")
            for i, s in enumerate(scheds)]
        self.n = len(self.sessions)

        d0 = self.sessions[0]
        for i, d in enumerate(self.sessions[1:], start=1):
            if _static(d.policy) != _static(d0.policy):
                raise ValueError(
                    f"session {i} breaks the pool's static composition: "
                    f"policy metadata (queue/window/tiers/...) must match "
                    f"session 0; only leaves (k, power_cap, freq_weight, "
                    f"ucb_scale) may differ")
            if (d.placer != d0.placer or d._retries != d0._retries
                    or d.capacity != d0.capacity
                    or d.warm_start != d0.warm_start
                    or d.device != d0.device):
                raise ValueError(
                    f"session {i} differs from session 0 in placer/retry/"
                    f"capacity/warm-start/device; those are static, one "
                    f"step serves one composition")
        self.capacity, self.device = d0.capacity, d0.device
        self._n_out = d0._n_out

        # the pool's context: the members' lanes side by side, one job
        # stream a lane, the pool's fused sites
        N, C = self.n, self.capacity
        wc = replace(w, prog=np.zeros((N, C), np.int32),
                     arrival=np.full((N, C), BIG, np.float32),
                     k_job=np.full((N, C), np.nan, np.float32))
        lanes = stack_sessions(_point_lanes(d.policy, d.seed, d.fault,
                                            self.device)
                               for d in self.sessions)
        ctx = event_context(d0._ctx["arrs"], wc, d0.policy, lanes,
                            d0.warm_start, d0.placer)
        ctx["site_lanes"] = None
        ctx.update(_job_draws(ctx))
        self._ctx = ctx
        # ONE step for the whole pool, built here and never again
        cons = d0.policy.queue == "conservative"
        self._step = (make_cons_step if cons else make_event_step)(
            d0.policy, d0.placer, totals_only=False, retries=d0._retries,
            live=True)
        self._carry = stack_sessions(d._carry for d in self.sessions)
        self._rec = _Record(N, C, self.device)
        for i, d in enumerate(self.sessions):
            d._bind(self, i)

        self._horizons = np.zeros(N, np.float32)
        self._buffers: list[list] = [[] for _ in range(N)]
        self.n_pool_steps = 0
        self.wall_us_total = 0.0
        self.wall_us_max = 0.0
        self._writer = AsyncWriter(maxsize=writer_queue)
        self._log_f = open(decision_log, "a") if decision_log else None

    @classmethod
    def replicate(cls, sched: Scheduler, n: int, w: Workload,
                  **kw) -> "SessionPool":
        """N sessions of one configuration (the ``--pool N`` CLI path)."""
        return cls([sched] * int(n), w, **kw)

    # ------------------------------------------------------------ intake
    def _flush(self, idxs) -> int:
        """Write the buffered submissions of sessions ``idxs`` into the
        stacked job tensors: one scatter per channel however many jobs
        and sessions flush, and the effective K recomputed as
        ``_job_draws`` computes it.  Lanes not flushed keep their tensors,
        so their steps stay no-ops."""
        si, ji, progv, tv, kv, touched = [], [], [], [], [], []
        for i in idxs:
            buf = self._buffers[i]
            if not buf:
                continue
            touched.append(i)
            base = self.sessions[i].n_submitted
            for off, (p, t, k) in enumerate(buf):
                si.append(i)
                ji.append(base + off)
                progv.append(p)
                tv.append(t)
                kv.append(np.nan if k is None else float(k))
        if not touched:
            return 0
        ints = _upload(np.array([si, ji, progv], np.int64), self.device)
        flts = _upload(np.array([tv, kv], np.float32), self.device)
        ctx = self._ctx
        at = (ints[0], ints[1])
        ctx["prog"].index_put_(at, ints[2])
        ctx["arrival"].index_put_(at, flts[0])
        ctx["kjob"].index_put_(at, flts[1])
        self._refresh_K()
        for i in touched:
            d, buf = self.sessions[i], self._buffers[i]
            n0 = d.n_submitted
            d._arrival_h[n0:n0 + len(buf)] = [t for _, t, _ in buf]
            d.n_submitted += len(buf)
            buf.clear()
        return len(si)

    def _refresh_K(self) -> None:
        """In place: the effective K of every lane's jobs (the job's own
        k, else the lane's), bit for bit ``_job_draws``' rule."""
        ctx = self._ctx
        torch.where(torch.isnan(ctx["kjob"]), ctx["k"][:, None],
                    ctx["kjob"], out=ctx["K"])

    def submit(self, session: int, prog: int, arrival: float | None = None,
               k: float | None = None) -> int:
        """Buffer one submission for ``session`` (validated now, written
        at that session's next drive or read).  Returns the job id,
        assigned at once: intake never waits on the pool, and makes no
        host synchronisation."""
        i = int(session)
        d = self.sessions[i]
        buf = self._buffers[i]
        t = float(d.now if arrival is None else arrival)
        last = float(buf[-1][1]) if buf else None
        d._validate_intake(prog, t, queued=len(buf), last=last)
        j = d.n_submitted + len(buf)
        buf.append((int(prog), t, k))
        d.metrics.observe_submit()
        return j

    # ------------------------------------------------------------- drive
    def _run(self):
        """Step the whole pool until globally quiescent under the
        per-session horizons, folding each lane's live row into its
        session (with the step's amortised wall time ``dt / N``)."""
        hor = _upload(self._horizons, self.device)
        limit = 16 * self.capacity + self._n_out + 64
        for _ in range(limit):
            t0 = time.perf_counter()
            self._carry, out = self._step(self._ctx, self._carry, hor)
            self._rec.add(out)
            rows = out["live"].tolist()      # the pool step's one sync
            dt_us = (time.perf_counter() - t0) * 1e6
            self.n_pool_steps += 1
            self.wall_us_total += dt_us
            self.wall_us_max = max(self.wall_us_max, dt_us)
            share = dt_us / self.n
            progress = False
            for d, row in zip(self.sessions, rows):
                rec = _host_record(row)
                d._fold(rec, share)
                progress = (progress or rec["pushed"] or rec["placed"]
                            or rec["advanced"])
            if not progress:
                break
        else:
            raise RuntimeError("pool drive exceeded its step budget — a "
                               "lane's carry is diverging (engine bug)")

    def drive(self, until: float = BIG, session: int | None = None):
        """Advance sessions to ``until``: all of them (returns
        ``{session: [decisions]}``) or one (returns its decisions).  The
        other lanes hold their last horizon: no-op steps, no drift."""
        idxs = list(range(self.n)) if session is None else [int(session)]
        self._flush(idxs)
        for i in idxs:
            self._horizons[i] = np.float32(until)
        n0 = [len(d.decisions) for d in self.sessions]
        self._run()
        new = {i: list(self.sessions[i].decisions[n0[i]:])
               for i in range(self.n)}
        self._log_decisions(new)
        return new[int(session)] if session is not None else new

    def drain(self, session: int | None = None):
        """Run sessions to completion (open horizon)."""
        return self.drive(BIG, session)

    def _log_decisions(self, new: dict):
        if self._log_f is None:
            return
        for i in sorted(new):
            for dec in new[i]:
                line = json.dumps({"session": i, **dec}) + "\n"
                self._writer.submit(self._log_f.write, line)

    # ----------------------------------------------------------- queries
    def now(self, session: int) -> float:
        return self.sessions[int(session)].now

    def metrics(self, session: int) -> dict:
        return self.sessions[int(session)].metrics.snapshot()

    def result(self, session: int):
        """The realized ``SimResult`` of one session (its buffer flushed
        first: a submitted job is part of the session before its lane is
        driven)."""
        i = int(session)
        self._flush([i])
        return self.sessions[i].result()

    def whatif(self, session: int, prog: int, arrival: float | None = None,
               k: float | None = None) -> dict:
        """Project a hypothetical submission into one session, from a copy
        of its lane stepped by the member's own one-lane step; the pool's
        state is not touched."""
        i = int(session)
        self._flush([i])
        return _whatif(self.sessions[i], prog, arrival, k)

    @property
    def mean_step_us(self) -> float:
        """Mean wall time of one pool step (all N lanes advance)."""
        return self.wall_us_total / max(self.n_pool_steps, 1)

    # -------------------------------------------------------- checkpoint
    def save(self, session: int | None = None, blocking: bool = True):
        """Checkpoint one session (returns its step id) or all (a list of
        ids).  ``blocking=False`` copies the state to the host now and
        hands the disk write to the writer thread."""
        idxs = list(range(self.n)) if session is None else [int(session)]
        self._flush(idxs)
        steps = []
        for i in idxs:
            d = self.sessions[i]
            if blocking:
                steps.append(d.save(blocking=True))
                continue
            if d._mgr is None:
                raise RuntimeError("no checkpoint_dir configured")
            step = d._save_step
            d._save_step = step + 1
            tree = map_with_names(                  # the snapshot, now
                lambda _, x: x.detach().to("cpu", copy=True), d._tree())
            meta = {"n_submitted": d.n_submitted,
                    "decisions": list(d.decisions),
                    "metrics": d.metrics.snapshot()}
            self._writer.submit(d._mgr.save, step, tree, metadata=meta,
                                blocking=True)
            steps.append(step)
        return steps if session is None else steps[0]

    def restore(self, session: int | None = None,
                step: int | None = None):
        """Restore one session (or all) from its namespaced checkpoints;
        only the restored lanes' rows change, and each resumes
        bit-identically.  Returns the call's success (all of them for the
        pool form)."""
        idxs = list(range(self.n)) if session is None else [int(session)]
        if any(self._buffers[i] for i in idxs):
            raise RuntimeError("restore with buffered submissions pending "
                               "— drive or drop them first")
        self._writer.flush()             # pending async saves land first
        ok = [self.sessions[i].restore(step) for i in idxs]
        # a member's restore redraws its own K; the lane's is recomputed
        self._refresh_K()
        for i in idxs:
            self.sessions[i]._ctx["K"] = self._ctx["K"][i:i + 1]
            self._horizons[i] = np.float32(self.sessions[i].now)
        return all(ok) if session is None else ok[0]

    # ----------------------------------------------------------- closing
    def close(self):
        """Drain the writer (decision log and non-blocking checkpoints) and
        close the log.  Idempotent."""
        if self._log_f is not None:
            self._writer.submit(self._log_f.flush)
        self._writer.close()
        if self._log_f is not None:
            self._log_f.close()
            self._log_f = None
        for d in self.sessions:
            if d._mgr is not None:
                d._mgr.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __repr__(self):
        return (f"SessionPool(n={self.n}, "
                f"queue={self.sessions[0].policy.queue or 'fcfs'!r}, "
                f"capacity={self.capacity}, steps={self.n_pool_steps})")
