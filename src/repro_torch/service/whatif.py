"""What-if queries: fork the live carry into a rollout.

An operator deciding whether (or when) to submit a job wants the
projected consequences — wait, system, cap headroom — WITHOUT committing
the submission.  ``whatif`` clones the dispatcher's carry and per-job
tensors, writes the hypothetical job into the next free slot of the
clones, and steps the SAME live step from the CURRENT carry with an open
horizon for the reference's fixed length (``mult * C + |outage| + 4``).
The steps write the carry in place, so the fork is a copy of every leaf:
the live carry and job tensors are never written, and the projection is
exactly what the session would realize if the job were submitted now and
no other job arrived after it.

A rollout may stop early: a step that neither pushes, places nor
advances under an open horizon leaves the decisions of every later step
unchanged (it can only repeat the cap-blocked time it already set), so
those steps are no-ops.  The rollout checks for one after every
``CHECK_EVERY`` steps, one host synchronisation each.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.events import _Record
from repro_torch.core.policy import BIG, UNCAPPED, _host
from repro_torch.utils.tree import map_with_names

#: steps between two quiescence checks of a rollout
CHECK_EVERY = 32


def rollout_length(disp) -> int:
    """The reference's rollout length for the dispatcher's queue."""
    mult = (9 if disp._retries else 5) \
        if disp.policy.queue == "conservative" \
        else (7 if disp._retries else 4)
    return mult * disp.capacity + disp._n_out + 4


def _rollout(step, ctx, carry, rec, length, every):
    """Step ``carry`` up to ``length`` times with an open horizon,
    recording into ``rec``; with ``every``, stop after the first check
    that finds a quiescent step.  Returns (carry, steps taken)."""
    done = 0
    while done < length:
        n = length - done if every is None else min(every, length - done)
        for _ in range(n):
            carry, out = step(ctx, carry, BIG)
            rec.add(out)
        done += n
        if every is not None and not bool(
                (out["pushed"] | out["placed"] | out["advanced"]).any()):
            break
    return carry, done


def whatif(disp, prog: int, arrival: float | None = None,
           k: float | None = None) -> dict:
    """Project submitting ``prog`` at ``arrival`` (default: now) into the
    live session, without mutating it.  Returns the hypothetical job's
    projected placement (system, start, wait, finish), the session-level
    projections (mean wait over all submitted + hypothetical jobs,
    makespan, peak power), and the cap headroom at the projected peak
    (``inf`` when uncapped)."""
    if disp.n_submitted >= disp.capacity:
        raise RuntimeError("session full: no free slot for a what-if job")
    if not 0 <= int(prog) < disp.w.T_true.shape[0]:
        raise ValueError(f"prog {prog} not in the facility catalog")
    t = float(disp.now if arrival is None else arrival)
    if t < disp.now:
        raise ValueError(f"arrival {t} is in the past (now={disp.now})")

    j = disp.n_submitted
    ctx = dict(disp._ctx)
    for key in ("prog", "arrival", "kjob", "K"):
        ctx[key] = ctx[key].clone()
    disp._write_job(ctx, j, prog, t, k)
    carry = map_with_names(lambda _, x: x.clone(), disp._carry)
    rec = _Record(1, disp.capacity, disp.device)
    carry, _ = _rollout(disp._step, ctx, carry, rec, rollout_length(disp),
                        CHECK_EVERY)

    # decided channels of already-finished jobs are zeros in the rollout's
    # record (their steps pre-date the fork): splice the realized values
    n = j + 1
    proj = rec.vals[0, :n].cpu().numpy()          # s0, finish, wait, T, bf
    live = disp._rec.vals[0, :n].cpu().numpy()
    wait, fin = live[:, 2].copy(), live[:, 1].copy()
    live_done = fin > 0
    wait[~live_done] = proj[:, 2][~live_done]
    fin[~live_done] = proj[:, 1][~live_done]

    cap = float(np.asarray(_host(disp.policy.power_cap)).reshape(-1)[0])
    peak = float(carry.peak[0])
    return {
        "job": {"prog": int(prog), "arrival": t,
                "system": int(rec.sel_x[0, j]) % ctx["S"],
                "start": float(proj[j, 0]), "wait": float(proj[j, 2]),
                "finish": float(proj[j, 1]),
                "backfilled": bool(proj[j, 4])},
        "mean_wait": float(wait.mean()) if n else 0.0,
        "makespan": float(fin.max()) if n else 0.0,
        "peak_power": peak,
        "cap_headroom": float("inf") if cap >= UNCAPPED else cap - peak,
    }
