"""The event-granular cores: FCFS and EASY on the event clock, and
conservative backfilling, with SCC power caps, mid-job failure re-queue,
maintenance windows and DVFS tiers.

Every lane of the flattened (fault x policy x seed) grid steps together;
each keeps its own clock ``now``, next-arrival cursor ``a`` and pending
buffer of ``window + 1`` slots.  A step does at least one of:

  push     admit the next arrival (due, and the buffer has room);
  place    at most one pending job whose start is feasible now:
           resource-feasible, discipline-eligible and under the lane's
           power cap (``power_cap`` < ``UNCAPPED``);
  advance  move ``now`` to the next event: the next arrival, the next
           node-free time after ``now`` (a completion) or outage end, and
           on the conservative core a reservation start.

``make_event_step`` (queues ``fcfs`` and ``easy_backfill``) scores every
slot against one node-free table per lane with one shared kth-free call
over [B, W + 1, S] requests (the CUDA kernel on the card); event-driven
EASY adds the head recheck over [B, W + 1, maxN] trial rows.
``make_cons_step`` (``conservative``) reserves each job at admission with
the piecewise-capacity earliest fit over the slot reservation table and
realizes reservations when the clock reaches them, after one kth-free
call over the reserved rows [B, W + 1, maxN].

The step count is static (``step_count``) and the loop makes no host
synchronisation: job data is gathered on the device by the cursor and
the slot table, and every choice is a masked reduction.  With ``chunk``
the steps run in windows, each reading the per-job draws of only the
jobs its lanes can touch (``engine._window_ids``: each lane's pending
and re-queued jobs, its next arrivals), so ``totals_only`` memory does
not grow with J.

A placement is deferred while ``P(now) - need * idle_w + E / T`` exceeds
the cap, where ``P(now)`` sums the node-power table (``_cluster_power``);
a cap below the idle floor opens the stuck valve (the head is forced
once no event is left).  With ``retries`` a failing first attempt
occupies its nodes for ``restart_overhead`` of its work and re-queues at
its failure time; the retry re-selects a system and never fails; the
tables learn once, at the final attempt, with the accrued factor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.engine import (F32, Workload, _chunks, _draw_cols,
                                     _earliest_shared, _job_draws, _kahan,
                                     _per_lane, _power_totals,
                                     _push_out_of_outage, _setup, _tier_rows,
                                     _window_ids)
from repro_torch.core.policy import BIG, UNCAPPED, Policy, select, select_batched
from repro_torch.kernels.kth_free.ops import (kth_free_time,
                                              kth_free_time_rows)
from repro_torch.utils.fp import fma

#: the event core's float slot columns, after the job id ``pend``
EVENT_COLS = ("t0", "rt", "accT", "accF", "accW", "s0", "pblock")
#: the conservative core's slot table, one float column each (ids, flags
#: and node counts are exact in float32 below 2^24), and each column's
#: fill for an empty slot (the sentinel job J in ``pend``)
CONS_COLS = ("pend", "t0", "rt", "accT", "accF", "accW", "s0", "pblock",
             "sel", "start", "fin", "T", "E", "need", "wjob", "fac", "fail",
             "tier")
FILLS = dict(t0=0.0, rt=0.0, accT=0.0, accF=0.0, accW=0.0, s0=0.0,
             pblock=BIG, sel=0.0, start=0.0, fin=0.0, T=1.0, E=0.0,
             need=0.0, wjob=0.0, fac=0.0, fail=0.0, tier=0.0)
CONS_IX = {name: i for i, name in enumerate(CONS_COLS)}
EVENT_IX = {name: i for i, name in enumerate(EVENT_COLS)}


def step_count(w: Workload, policy: Policy, retries: bool) -> int:
    """The static step count of the event cores: every job needs one push
    and one placement and every advance lands on a distinct event time,
    so ``4J + |outage| + 4`` steps suffice (``7J`` with retries: a
    failure adds a push, a placement and an event); conservative
    reservation starts add at most one advance each (``5J`` / ``9J``)."""
    J = len(w.prog)
    n_out = 0 if w.outage is None else int(np.asarray(w.outage)[..., 1].size)
    if policy.queue == "conservative":
        return (9 if retries else 5) * J + n_out + 4
    return (7 if retries else 4) * J + n_out + 4


#: the column width of one partial sum of the cluster draw
POWER_WINDOW = 32


def power_order(S: int, N: int, device) -> tuple:
    """The order in which ``_cluster_power`` adds an [S, N] draw table, as
    the reference's compiled step adds it (its reduction is rewritten
    into column windows of ``POWER_WINDOW``, the padding split evenly
    with the smaller half in front): each window's entries row by row in
    float32, then the window sums in order.  Returns the flat element
    order [S * N], each window's offsets into it, and the offsets of the
    one segment that adds the window sums."""
    if S * N <= POWER_WINDOW:
        bounds = [(0, N)]
    else:
        n_win = -(-N // POWER_WINDOW)
        lo = (n_win * POWER_WINDOW - N) // 2
        bounds = [(max(0, w * POWER_WINDOW - lo),
                   min(N, (w + 1) * POWER_WINDOW - lo)) for w in range(n_win)]
    order = [s * N + n for a, b in bounds for s in range(S)
             for n in range(a, b)]
    offsets = np.cumsum([0] + [S * (b - a) for a, b in bounds])
    return (torch.tensor(order, dtype=torch.int64, device=device),
            torch.as_tensor(offsets, device=device),
            torch.tensor([0, len(bounds)], device=device))


def _seq_sum(x, offsets):
    """Float32 sums of consecutive segments of each row of ``x`` [B, L],
    each added one element after the other (``segment_reduce`` loops over
    a segment in order when the data has a leading batch dimension)."""
    return torch.segment_reduce(x, "sum", offsets=offsets.expand(
        x.shape[0], -1), axis=1, unsafe=True)


def _cluster_power(draw, order):
    """Cluster draw per lane: the sum of ``draw`` [B, S, maxN] in the
    reference's order (``power_order``), the same on every device."""
    idx, offsets, whole = order
    parts = _seq_sum(draw.reshape(draw.shape[0], -1).index_select(1, idx),
                     offsets)
    return _seq_sum(parts, whole).squeeze(1)


def _alloc_take(rows, kth, need):
    """The nodes ``_alloc_row`` takes: [..., N] rows, [...] kth / need."""
    k = kth.unsqueeze(-1)
    below = rows < k
    tie = rows == k
    room = (need - below.sum(-1)).unsqueeze(-1)
    return below | (tie & (tie.cumsum(-1) - 1 < room))


class EventCarry(NamedTuple):
    """Live state of the event core between two steps, [B]-leading."""
    node_free: torch.Tensor   # [B, S, maxN] node free-from times
    node_pow: torch.Tensor    # [B, S, maxN] per-node allocated draw (W)
    CT: torch.Tensor          # [B, P, S, 2] learned (C, T)
    runs: torch.Tensor        # [B, P, S] observation counts
    acc: tuple                # Kahan totals (empty on the full path)
    busy: torch.Tensor        # [B, S] busy node-seconds
    pend: torch.Tensor        # [B, Wc] pending job ids (J = sentinel)
    cols: torch.Tensor        # [B, Wc, 7] the ``EVENT_COLS`` per slot
    a: torch.Tensor           # [B] next-arrival cursor
    now: torch.Tensor         # [B] event clock
    nbf: torch.Tensor         # [B] backfill count
    peak: torch.Tensor        # [B] running peak cluster draw
    cdel: torch.Tensor        # [B] cap-attributed placement delay


class ConsCarry(NamedTuple):
    """Live state of the conservative core: ``EventCarry``'s fields, with
    the pending buffer as one slot table ``slots`` [B, Wc, 18] (the
    ``CONS_COLS``: job id, accruals and the reservation row)."""
    node_free: torch.Tensor
    node_pow: torch.Tensor
    CT: torch.Tensor
    runs: torch.Tensor
    acc: tuple
    busy: torch.Tensor
    slots: torch.Tensor
    a: torch.Tensor
    now: torch.Tensor
    nbf: torch.Tensor
    peak: torch.Tensor
    cdel: torch.Tensor


def event_context(arrs: dict, w: Workload, policy: Policy, lanes: dict,
                  warm_start: bool, placer: str | None = None) -> dict:
    """Everything a step reads besides its carry: ``_setup``'s tables, the
    job stream on the device ([J], every lane's; or [B, J] when ``w``'s
    ``prog`` / ``arrival`` / ``k_job`` are 2-D, one stream a lane, as a
    session pool holds them), the power model, and the constant rows the
    steps push and pop.  The per-job draws (``engine._job_draws``) join it
    per chunk.  ``site_lanes`` is the lane count whose fused multiply-add
    sites the steps take (``_fusions``): B here; a session pool sets
    None, its own map."""
    J = np.shape(w.prog)[-1]
    if J >= 1 << 24:
        raise ValueError("the event cores keep job ids in float32 columns; "
                         f"J must stay below 2^24, got {J}")
    ctx = _setup(arrs, w, policy, lanes, warm_start)
    dev, S, FS, P, B = ctx["dev"], ctx["S"], ctx["FS"], ctx["P"], ctx["B"]
    exists = arrs["free0"] < BIG
    pc = lanes["power_cap"]
    f32 = lambda v: torch.tensor(v, dtype=F32, device=dev)  # noqa: E731
    ctx.update(
        # event EASY's head recheck: every kth-free mode is bit-exact, so
        # absent a placer the kernel on the card and one sort on the CPU
        recheck=placer or ("cuda" if dev.type == "cuda" else "sort"),
        push_tail=f32([0.0] * 5 + [BIG]).view(1, 1, 6),
        pop_fill=f32([0.0] * 6 + [BIG]).view(1, 1, 7),
        sentinel=torch.full((B, 1), J, dtype=torch.int64, device=dev),
        admit_tail=f32([0.0] * 5 + [BIG]).view(1, 6),
        cons_fill=f32([float(J)] + [FILLS[c] for c in CONS_COLS[1:]])
        .view(1, 1, len(CONS_COLS)))
    ctx.update(
        arrs=arrs,
        prog=torch.as_tensor(np.asarray(w.prog).astype(np.int64), device=dev),
        arrival=torch.as_tensor(np.asarray(w.arrival, np.float32),
                                device=dev),
        site_lanes=B,
        outage=arrs.get("outage"),
        idle_mat=torch.where(exists, arrs["idle_w"][:, None], 0.0),
        pc=pc, capped=pc < UNCAPPED,
        fv3=lanes["fvec"][:, 3],
        # per-candidate job draw (W): tier-major under DVFS tiers
        w_flat=(ctx["tt"]["w"].reshape(P, FS) if ctx["tiered"]
                else arrs["w_pow"]),
        slot=torch.arange(int(policy.window) + 1, device=dev),
        power_order=power_order(S, ctx["N"], dev),
        sys_col=torch.arange(S, device=dev, dtype=F32).view(1, S, 1, 1))
    if ctx["outage"] is not None:
        ctx["out_ends"] = ctx["outage"][..., 1].reshape(1, -1)
    return ctx


def _acc0(ctx, totals_only):
    B, dev = ctx["B"], ctx["dev"]
    if not totals_only:
        return ()
    z = lambda *s: torch.zeros(s, dtype=F32, device=dev)  # noqa: E731
    return (z(B, 3), z(B, 3), z(B), z(B))


def _common0(ctx, totals_only, now0=None):
    """The carry fields both cores start from: the opening clock is the
    first arrival (``now0`` when given: a live session opens at 0), the
    running peak the all-idle draw."""
    B, dev = ctx["B"], ctx["dev"]
    idle_total = _cluster_power(ctx["idle_mat"].unsqueeze(0),
                                ctx["power_order"])
    now = (ctx["arrival"][..., 0].expand(B).clone() if now0 is None
           else torch.full((B,), float(now0), dtype=F32, device=dev))
    return dict(
        node_free=ctx["node_free"], node_pow=torch.zeros_like(ctx["node_free"]),
        CT=ctx["CT"], runs=ctx["runs"], acc=_acc0(ctx, totals_only),
        busy=torch.zeros((B, ctx["S"]), dtype=F32, device=dev),
        a=torch.zeros(B, dtype=torch.int64, device=dev), now=now,
        nbf=torch.zeros(B, dtype=torch.int32, device=dev),
        peak=idle_total.expand(B).clone(),
        cdel=torch.zeros(B, dtype=F32, device=dev))


def event_carry0(ctx: dict, totals_only: bool, now0=None) -> EventCarry:
    """The event core's initial carry (clock at ``now0`` when given)."""
    B, Wc = ctx["B"], len(ctx["slot"])
    return EventCarry(
        pend=ctx["sentinel"].expand(B, Wc).clone(),
        cols=ctx["pop_fill"].expand(B, Wc, len(EVENT_COLS)).clone(),
        **_common0(ctx, totals_only, now0))


def cons_carry0(ctx: dict, totals_only: bool, now0=None) -> ConsCarry:
    """The conservative core's initial carry: every slot empty."""
    B, Wc = ctx["B"], len(ctx["slot"])
    return ConsCarry(
        slots=ctx["cons_fill"].expand(B, Wc, len(CONS_COLS)).clone(),
        **_common0(ctx, totals_only, now0))


def _next_event(ctx, node_free, a, now):
    """The earliest of the next arrival, node-free time and outage end
    after ``now``, per lane (BIG when none is left)."""
    J, arrival = ctx["J"], ctx["arrival"]
    B = now.shape[0]
    nxt = torch.where(node_free > now.view(B, 1, 1), node_free,
                      BIG).amin((1, 2))
    arr_next = _per_lane(arrival, a.clamp_max(J - 1).unsqueeze(1)).squeeze(1)
    nxt = torch.minimum(nxt, torch.where((a < J) & (arr_next > now),
                                         arr_next, BIG))
    if "out_ends" in ctx:
        ends = ctx["out_ends"]
        nxt = torch.minimum(nxt, torch.where(ends > now.unsqueeze(1), ends,
                                             BIG).amin(1))
    return nxt


def _table_terms(old, n, obs, fac, fuse_obs):
    """``(a, b, c)`` of the table update's multiply-add ``a * b + c`` =
    ``old * n + truth * fac`` [..., 2], with the product the reference's
    compiled step fuses: ``truth * fac`` when ``fuse_obs``, else ``old *
    n`` (``_fusions``).  n / fac: [...]."""
    n, fac = n.unsqueeze(-1), fac.unsqueeze(-1)
    if fuse_obs:
        return obs, fac.expand_as(obs), old * n
    return old, n.expand_as(old), obs * fac


def _table_write(CT, runs, S, p, sel, tot, old, n, final):
    """In place: the learned tables absorb one final attempt (where
    ``final``): ``tot / (n + 1)`` at (p, sel), and one more run.  tot /
    old: [B, 2]; n: [B]."""
    B = p.shape[0]
    flat = (p * S + sel).unsqueeze(1)                            # [B, 1]
    flat2 = flat.unsqueeze(-1).expand(B, 1, 2)
    CT.view(B, -1, 2).scatter_(1, flat2, torch.where(
        final.unsqueeze(1), tot / (n.unsqueeze(1) + 1), old).unsqueeze(1))
    runs.view(B, -1).scatter_add_(1, flat,
                                  final.to(torch.int32).unsqueeze(1))


def _table_update(CT, runs, truth, S, p, sel, fac, final, fuse_obs):
    """``_table_write`` of one attempt per lane on system ``sel`` of
    program ``p``, with its own fused multiply-add."""
    B = p.shape[0]
    flat = (p * S + sel).unsqueeze(1)
    old = CT.view(B, -1, 2).gather(1, flat.unsqueeze(-1).expand(B, 1, 2)) \
        .squeeze(1)                                              # [B, 2]
    n = runs.view(B, -1).gather(1, flat).squeeze(1).to(F32)      # [B]
    tot = fma(*_table_terms(old, n, truth[p, sel], fac, fuse_obs))
    _table_write(CT, runs, S, p, sel, tot, old, n, final)


def _set_row(node_free, node_pow, sel, take, finish, per_node):
    """In place: the taken nodes of each lane's row ``sel`` become busy
    until ``finish`` at ``per_node`` watts.  take: [B, 1, N]."""
    B, _, N = node_free.shape
    idx = sel.view(B, 1, 1).expand(B, 1, N)
    for table, val in ((node_free, finish), (node_pow, per_node)):
        table.scatter_(1, idx, torch.where(take, val.view(B, 1, 1),
                                           table.gather(1, idx)))


def _totals_step(acc, placed, final, E_act, wait_tot, T_tot, finish):
    """The Kahan totals after one step, updated only where a job was
    placed (so FCFS's op sequence equals the arrival core's)."""
    sums, comps, fin_max, wait_max = acc
    add = torch.stack([E_act, torch.where(final, wait_tot, 0.0),
                       torch.where(final, (wait_tot + T_tot) / T_tot, 0.0)],
                      1)
    t, c = _kahan(sums, comps, add)
    pl = placed.unsqueeze(1)
    return (torch.where(pl, t, sums), torch.where(pl, c, comps),
            torch.maximum(fin_max, torch.where(placed, finish, 0.0)),
            torch.maximum(wait_max, torch.where(final, wait_tot, 0.0)))


def _choose(elig, slot, Wc):
    """The least eligible slot per lane (``Wc`` = none), placed, and the
    gather index [B, 1]."""
    chosen = torch.where(elig, slot, Wc).amin(1)
    return chosen, chosen < Wc, chosen.clamp_max(Wc - 1).unsqueeze(1)


def _gate(ctx, table, pbi, node_free, node_pow, now, needs, sels, w_jobs,
          elig_res, forced, do_push, next_evt, horizon):
    """Both cores' choice among resource-eligible slots ``elig_res``: the
    power gate (the draw now, less the slot's idle nodes, plus its job,
    under the lane's cap); the stuck valve (with nothing placeable and no
    event left, which only a cap below the idle floor causes, the
    ``forced`` slots may go in the batch run, ``horizon >= BIG``); the
    least eligible slot; and the cap-attributed block time in column
    ``pbi`` of the slot ``table``.  A [B] ``horizon`` (a pool's) opens the
    valve in its drained lanes (``horizon >= BIG``) only.  Returns
    (chosen, placed, gather index, the draw after placing each slot, the
    table, the draw now)."""
    slot, (B, Wc) = ctx["slot"], table.shape[:2]
    p_now = _cluster_power(torch.where(node_free > now.view(B, 1, 1),
                                       node_pow, ctx["idle_mat"]),
                           ctx["power_order"])
    new_P = p_now.unsqueeze(1) - needs * ctx["arrs"]["idle_w"][sels] + w_jobs
    power_ok = ~ctx["capped"].unsqueeze(1) | (new_P <= ctx["pc"].unsqueeze(1))
    elig0 = elig_res & power_ok
    elig = elig0
    per_lane = isinstance(horizon, torch.Tensor)
    if per_lane or horizon >= BIG:
        stuck = (forced.any(1) & ~do_push & ~elig0.any(1)
                 & (next_evt >= BIG))
        if per_lane:
            stuck = stuck & (horizon >= BIG)
        elig = elig0 | (forced & stuck.unsqueeze(1))
    chosen, placed, ci = _choose(elig, slot, Wc)

    # cap-attributed delay: the next would-be placement, power-blocked
    chosen_res, _, cri = _choose(elig_res, slot, Wc)
    blocked = (chosen_res < Wc) & ~power_ok.gather(1, cri).squeeze(1)
    pb = table[..., pbi]
    pb_new = torch.where(blocked.unsqueeze(1) & (slot == cri),
                         torch.minimum(pb, now.unsqueeze(1)), pb)
    table = torch.cat([table[..., :pbi], pb_new.unsqueeze(-1),
                       table[..., pbi + 1:]], -1)
    return chosen, placed, ci, new_P, table, p_now


#: the live-decision channels of a ``live`` step, in the order of its
#: ``out["live"]`` row: the reference's (``pushed`` ... ``tier``, ``bf``),
#: then the final attempt's values and the ids the record scatters by
LIVE_COLS = ("pushed", "j_push", "placed", "final", "advanced", "start",
             "now", "qlen", "power", "sys", "tier", "bf", "s0", "finish",
             "wait", "T", "j_fin", "j_add", "E")


def _settle(ctx, carry, horizon, totals_only, *, do_push, next_evt, chosen,
            placed, final, jj, sel, sel_x, need, T_act, E_act, P_ci, pb_ci,
            s0, finish, wait_tot, T_tot, live=False, a=None, start=None,
            p_now=None, pending=None):
    """The end of a step on both cores, after the placement's tables:
    busy node-seconds, the backfill count, the running peak draw and the
    cap-attributed delay; the clock's advance when nothing else happened
    (never past ``horizon``); the Kahan totals, or the step's result
    channels, with ``live`` also the live-decision channels (``a``: the
    cursor after the push, ``start``: the chosen slot's start, ``p_now``:
    the draw before placing, ``pending``: the job-id column after the
    pop).  Returns (acc, busy, now, nbf, peak, cdel, out)."""
    J, now = ctx["J"], carry.now
    busy = carry.busy
    busy.scatter_add_(1, sel.unsqueeze(1), torch.where(
        placed, T_act * need, 0.0).unsqueeze(1))
    backfill = final & (chosen > 0)
    nbf = carry.nbf + backfill.to(torch.int32)
    peak = torch.maximum(carry.peak, torch.where(placed, P_ci, 0.0))
    cdel = carry.cdel + torch.where(placed & (pb_ci < BIG), now - pb_ci, 0.0)

    advance = ~do_push & ~placed & (next_evt < BIG)
    if isinstance(horizon, torch.Tensor) or horizon < BIG:
        advance = advance & (next_evt <= horizon)
    now = torch.where(advance, next_evt, now)

    acc, out = carry.acc, None
    if totals_only:
        acc = _totals_step(acc, placed, final, E_act, wait_tot, T_tot,
                           finish)
    else:
        out = dict(j_add=torch.where(placed, jj, J), E=E_act,
                   j_fin=torch.where(final, jj, J), sel_x=sel_x,
                   vals=torch.stack([s0, finish, wait_tot, T_tot,
                                     backfill.to(F32)], 1))
        if live:
            out.update(pushed=do_push, j_push=torch.where(do_push, a - 1, J),
                       placed=placed, final=final, advanced=advance,
                       start=start, now=now, qlen=(pending < J).sum(1),
                       power=torch.where(placed, P_ci, p_now), sys=sel,
                       tier=sel_x // ctx["S"], bf=backfill, s0=s0,
                       finish=finish, wait=wait_tot, T=T_tot)
            # one row per lane, so a session copies its step to the host
            # once (ids and counts are exact in float32 below 2^24)
            out["live"] = torch.stack([out[c] for c in LIVE_COLS], 1).to(F32)
    return acc, busy, now, nbf, peak, cdel, out


def _fusions(queue: str, lanes, retries: bool) -> dict:
    """Where the reference's compiled steps fuse a multiply-add, for
    ``queue`` and the context's ``site_lanes`` (``lanes``): ``obs``, the
    table update fuses ``truth * fac`` (else ``old * n``); ``T_tot``, the
    retry's runtime ``accT + T * factor`` is fused; ``fin``, the
    conservative reservation's finish is fused.  In a batch run: with
    retries the event step fuses ``truth * fac`` and, at one FCFS lane,
    ``old * n`` with the retry's runtime fused too; the conservative step
    fuses ``truth * fac`` with retries, and the finish at one lane.  A
    session pool (``lanes`` None) fuses as the reference's pool does,
    whose steps run every lane as one session under ``vmap``: ``truth *
    fac`` always, the retry's runtime and the finish never.  Read from
    the reference's results on the CPU; each cell of the batch map (queue
    x one lane or several x retries x tiers) is held by
    ``tests/test_torch_fusion_map.py``, the pool's by
    ``tests/test_torch_service_pool.py``."""
    if lanes is None:
        return {"obs": True, "T_tot": False, "fin": False}
    if queue == "conservative":
        return {"obs": retries, "T_tot": False, "fin": lanes == 1}
    one_fcfs = lanes == 1 and queue != "easy_backfill"
    return {"obs": retries and not one_fcfs, "T_tot": retries and one_fcfs,
            "fin": False}


def _check_live(live, totals_only):
    if live and totals_only:
        raise ValueError("a live step reports per-job channels; it has no "
                         "totals_only form")


def make_event_step(policy: Policy, placer: str | None = None,
                    totals_only: bool = False, retries: bool = False,
                    live: bool = False):
    """The event core's step for ``queue="fcfs"`` or ``"easy_backfill"``:
    ``step(ctx, carry, horizon) -> (carry, out)``.  ``horizon`` (a float)
    gates the clock: ``advance`` never moves ``now`` past it, and the
    stuck valve opens only with ``horizon >= BIG`` (the batch run).
    A [B] tensor ``horizon`` gates each lane by its own (a session pool:
    held lanes stay where they are, their steps no-ops on the carry).
    ``out`` is None with ``totals_only``, else the step's result channels
    (``_Record`` scatters them to arrival order); ``live`` adds the
    live-decision channels (``LIVE_COLS``) and their row ``out["live"]``
    for the service dispatcher."""
    _check_live(live, totals_only)
    Wc = int(policy.window) + 1
    easy = policy.queue == "easy_backfill"
    tiered = policy.tiered

    def step(ctx, carry: EventCarry, horizon: float = BIG):
        J, S, N, B = ctx["J"], ctx["S"], ctx["N"], ctx["B"]
        slot, arrival, prog = ctx["slot"], ctx["arrival"], ctx["prog"]
        arrs, outage, capped = ctx["arrs"], ctx["outage"], ctx["capped"]
        fuse = _fusions(policy.queue, ctx["site_lanes"], retries)
        (node_free, node_pow, CT, runs, acc, busy, pend, cols, a, now, nbf,
         peak, cdel) = carry

        # ---- push: admit the next arrival if due and there is room
        size0 = (pend < J).sum(1)
        arr_a = _per_lane(arrival, a.clamp_max(J - 1).unsqueeze(1)) \
            .squeeze(1)
        do_push = (a < J) & (size0 < Wc) & (arr_a <= now)
        at = do_push.unsqueeze(1) & (slot == size0.clamp_max(Wc - 1)
                                     .unsqueeze(1))
        pend = torch.where(at, a.unsqueeze(1), pend)
        cols = torch.where(at.unsqueeze(-1), torch.cat(
            [arr_a.view(B, 1, 1), ctx["push_tail"].expand(B, 1, 6)], -1),
            cols)
        a = a + do_push

        next_evt = _next_event(ctx, node_free, a, now)

        # ---- every slot against the same node-free table (sentinel slots
        # evaluate job J - 1 behind a BIG arrival floor; never eligible)
        valid = pend < J
        jjs = pend.clamp_max(J - 1)
        jd = _draw_cols(ctx, jjs)
        ps = _per_lane(prog, jjs)
        t0f = torch.where(valid, cols[..., 0], BIG)
        nreq_rows = arrs["n_req"][ps]                            # [B, Wc, S]
        kths, avails = _earliest_shared(node_free, nreq_rows,
                                        t0f.unsqueeze(-1), placer, outage)
        ct = CT.gather(1, ps[..., None, None].expand(B, Wc, S, 2))
        rows = (ct[..., 0], ct[..., 1],
                runs.gather(1, ps.unsqueeze(-1).expand(B, Wc, S)), avails,
                arrs["C_pred"][ps], arrs["T_pred"][ps])
        if tiered:
            rows = _tier_rows(ctx["tt"], ps, *rows)
        runs_rows = rows[2]
        c_r, t_r, r_r, a_r, cp_r, tp_r = rows
        draws = ctx["draws"]
        sels_x = select_batched(
            ctx["pol"], c_rows=c_r, t_rows=t_r, runs_rows=r_r, avail_rows=a_r,
            k=ctx["K"].gather(1, jd), c_pred_rows=cp_r, t_pred_rows=tp_r,
            draws=None if draws is None else draws.gather(1, jd))
        sels = sels_x % S if tiered else sels_x                  # [B, Wc]
        on_sel = lambda x: x.gather(-1, sels.unsqueeze(-1)).squeeze(-1)  # noqa: E731
        starts_res = on_sel(avails)

        # fault draws, keyed by job id
        fails = ctx["fail"].gather(1, jd)
        if retries:      # a retry (rt = 1) never fails again
            first_fail = fails & (cols[..., EVENT_IX["rt"]] == 0)
            scale = torch.where(first_fail, ctx["fv3"].unsqueeze(1), 1.0)
        else:
            scale = torch.where(fails, 1.0 + ctx["fv3"].unsqueeze(1), 1.0)
        factors = ctx["slow"].gather(1, jd) * scale
        ac = ctx["act"][ps, sels_x]                              # [B, Wc, 2]
        T_acts, E_acts = (ac * factors.unsqueeze(-1)).unbind(-1)
        needs = on_sel(nreq_rows)
        # capped runs start at the current event (an exact power trace);
        # uncapped ones keep the resource-earliest start
        starts = torch.where(capped.unsqueeze(1),
                             torch.maximum(starts_res, now.unsqueeze(1)),
                             starts_res)
        # every fused multiply-add of the step, per slot, in one call: the
        # table update as the tables stand now, FCFS's finish (EASY's is
        # a plain add) and, where it is fused, the retry's runtime
        old = ct.gather(2, sels.view(B, Wc, 1, 1).expand(B, Wc, 1, 2)) \
            .squeeze(2)                                          # [B, Wc, 2]
        n_runs = on_sel(runs_rows).to(F32)
        fac_tot = (cols[..., EVENT_IX["accF"]] + factors if retries
                   else factors)
        terms = [_table_terms(old, n_runs, ctx["truth"][ps, sels], fac_tot,
                              fuse["obs"])]
        if not easy:
            terms.append((ac[..., :1], factors.unsqueeze(-1),
                          starts.unsqueeze(-1)))
        if fuse["T_tot"]:
            terms.append((ac[..., :1], factors.unsqueeze(-1),
                          cols[..., EVENT_IX["accT"]:EVENT_IX["accT"] + 1]))
        fused = fma(*(torch.cat(x, -1) for x in zip(*terms)))    # [B, Wc, k]
        finishes = starts + T_acts if easy else fused[..., 2]
        rows_sel = node_free.gather(1, sels.unsqueeze(-1).expand(B, Wc, N))
        takes = _alloc_take(rows_sel, on_sel(kths), needs)       # [B, Wc, N]

        # ---- discipline eligibility (resource side)
        res_ok = valid & (starts_res <= now.unsqueeze(1))
        if outage is not None:
            # a start deferred to ``now`` must itself clear the windows
            gated = _push_out_of_outage(starts, outage[sels])
            res_ok = res_ok & (~capped.unsqueeze(1)
                               | (gated <= now.unsqueeze(1)))
        if easy:
            # event-driven EASY: a slot may go if its trial allocation
            # does not delay the head's reservation on the head's system
            sel_h = sels[:, 0]
            r_h = starts_res[:, :1]
            trials = torch.where(takes, finishes.unsqueeze(-1), rows_sel)
            head_row = node_free.gather(1, sel_h.view(B, 1, 1).expand(B, 1, N))
            trial_h = torch.where((sels == sel_h.unsqueeze(1)).unsqueeze(-1),
                                  trials, head_row)              # [B, Wc, N]
            kth_h2 = kth_free_time(trial_h, needs[:, :1].expand(B, Wc),
                                   force=ctx["recheck"])
            avail_h2 = torch.maximum(kth_h2, t0f[:, :1])
            if outage is not None:
                avail_h2 = _push_out_of_outage(avail_h2,
                                               outage[sel_h].unsqueeze(1))
            elig_res = res_ok & ((slot == 0) | (avail_h2 <= r_h))
        else:
            elig_res = res_ok & (slot == 0)

        # ---- power feasibility, the stuck valve (it forces the head) and
        # the choice
        w_jobs = ctx["w_flat"][ps, sels_x]                       # [B, Wc]
        chosen, placed, ci, new_P, cols, p_now = _gate(
            ctx, cols, EVENT_IX["pblock"], node_free, node_pow, now, needs,
            sels, w_jobs, elig_res, valid & (slot == 0), do_push, next_evt,
            horizon)

        # ---- place the chosen slot (its trial IS the allocation)
        pick = lambda x: x.gather(1, ci).squeeze(1)  # noqa: E731
        jj, p, sel_x, sel, need = (pick(jjs), pick(ps), pick(sels_x),
                                   pick(sels), pick(needs))
        per_slot = torch.cat([torch.stack(
            [T_acts, E_acts, starts, finishes, w_jobs, new_P, n_runs,
             fac_tot], -1), old, fused], -1)
        picked = per_slot.gather(1, ci.unsqueeze(-1).expand(
            B, 1, per_slot.shape[-1])).squeeze(1)
        T_act, E_act, start, finish, w_job, P_ci, n_ci, fac_tot = \
            picked[:, :8].unbind(-1)
        old_ci, tot_ci = picked[:, 8:10], picked[:, 10:12]
        t0_ci, rt_ci, accT_ci, accF_ci, accW_ci, s0_ci, pb_ci = cols.gather(
            1, ci.unsqueeze(-1).expand(B, 1, len(EVENT_COLS))).squeeze(1) \
            .unbind(-1)
        if retries:
            ff = pick(first_fail)
            failed_now, final = placed & ff, placed & ~ff
        else:
            final = placed
        s0_ci = torch.where(rt_ci != 0, s0_ci, start)
        wait_step = start - t0_ci

        take = takes.gather(1, ci.unsqueeze(-1).expand(B, 1, N)) \
            & placed.view(B, 1, 1)
        _set_row(node_free, node_pow, sel, take, finish,
                 w_job / need.clamp_min(1).to(F32))
        _table_write(CT, runs, S, p, sel, tot_ci, old_ci, n_ci, final)

        # ---- pop the chosen slot (shift the tail left; none: no-op)
        keep = slot < chosen.unsqueeze(1)
        pend = torch.where(keep, pend, torch.cat([pend[:, 1:], ctx["sentinel"]],
                                                 1))
        cols = torch.where(keep.unsqueeze(-1), cols, torch.cat(
            [cols[:, 1:], ctx["pop_fill"].expand(B, 1, len(EVENT_COLS))], 1))

        if retries:
            # a failed first attempt re-queues at the tail, arriving at its
            # failure time (a completion event)
            T_tot = picked[:, -1] if fuse["T_tot"] else accT_ci + T_act
            wait_tot = accW_ci + wait_step
            size2 = (pend < J).sum(1, keepdim=True)
            at2 = failed_now.unsqueeze(1) & (slot == size2.clamp_max(Wc - 1))
            pend = torch.where(at2, jj.unsqueeze(1), pend)
            cols = torch.where(at2.unsqueeze(-1), torch.stack(
                [finish, torch.ones_like(finish), T_tot, fac_tot, wait_tot,
                 s0_ci, torch.full_like(finish, BIG)], -1).unsqueeze(1), cols)
        else:
            T_tot, wait_tot = T_act, wait_step

        acc, busy, now, nbf, peak, cdel, out = _settle(
            ctx, carry, horizon, totals_only, do_push=do_push,
            next_evt=next_evt, chosen=chosen, placed=placed, final=final,
            jj=jj, sel=sel, sel_x=sel_x, need=need, T_act=T_act,
            E_act=E_act, P_ci=P_ci, pb_ci=pb_ci, s0=s0_ci, finish=finish,
            wait_tot=wait_tot, T_tot=T_tot, live=live, a=a, start=start,
            p_now=p_now, pending=pend)
        return EventCarry(node_free, node_pow, CT, runs, acc, busy, pend,
                          cols, a, now, nbf, peak, cdel), out

    return step


def _earliest_fit(ctx, need, t0, Tdur, node_free, slots):
    """Per lane and system (and tier, when ``Tdur`` is [B, F, S]) the
    earliest start where free capacity, the really-free nodes less the
    reservations' occupancy, covers ``need`` [B, S] nodes for the whole
    [t, t + Tdur).  Candidates: the arrival floor ``t0`` [B], node free
    times and reservation finishes (the only capacity rises), each
    checked against every reservation start inside its window (the only
    dips)."""
    B, S, N = node_free.shape
    Wc = slots.shape[1]
    outage = ctx["outage"]
    col = lambda name: slots[..., CONS_IX[name]]  # noqa: E731
    r_valid = col("pend") < ctx["J"]
    r_sta = col("start").view(B, 1, 1, Wc)
    r_fin = col("fin").view(B, 1, 1, Wc)
    cands = torch.cat([t0.view(B, 1, 1).expand(B, S, 1), node_free,
                       col("fin").view(B, 1, Wc).expand(B, S, Wc)], -1)
    cands = torch.maximum(cands, t0.view(B, 1, 1))               # [B, S, E]
    if outage is not None:
        # start gating only: jobs ride through windows
        cands = _push_out_of_outage(cands, outage.unsqueeze(1))
    E = cands.shape[-1]
    q = torch.cat([cands, col("start").view(B, 1, Wc).expand(B, S, Wc)],
                  -1).unsqueeze(-1)                              # [B, S, Q, 1]
    cnt = (node_free.unsqueeze(2) <= q).sum(-1)                  # [B, S, Q]
    on_sys = r_valid.view(B, 1, 1, Wc) & (col("sel").view(B, 1, 1, Wc)
                                          == ctx["sys_col"])     # [B, S, 1, Wc]
    occ = torch.where(on_sys & (r_sta <= q) & (q < r_fin),
                      col("need").view(B, 1, 1, Wc), 0.0).sum(-1)
    availn = cnt - occ                                           # [B, S, Q]
    cap_ok = availn[..., :E] >= need.unsqueeze(-1)               # [B, S, E]
    rs_ok = availn[..., E:] >= need.unsqueeze(-1)                # [B, S, Wc]
    F = Tdur.numel() // (B * S)
    c5 = cands.view(B, 1, S, E, 1)
    s5 = r_sta.view(B, 1, 1, 1, Wc)
    dips = (on_sys.view(B, 1, S, 1, Wc) & (c5 < s5)
            & (s5 < c5 + Tdur.view(B, F, S, 1, 1)))
    dip_ok = (~dips | rs_ok.view(B, 1, S, 1, Wc)).all(-1)        # [B, F, S, E]
    fit = torch.where(cap_ok.unsqueeze(1) & dip_ok, cands.unsqueeze(1),
                      BIG).amin(-1)                              # [B, F, S]
    return fit if Tdur.dim() == 3 else fit.squeeze(1)


def _reserve(ctx, jp, t0, is_retry, retries, node_free, slots, CT, runs,
             fused_fin):
    """Admission of job ``jp`` [B] arriving at ``t0`` [B]: its fault draw,
    hole-aware earliest fit and selection, as the reservation columns
    ``CONS_COLS[8:]`` [B, 10]; ``fused_fin``: the finish is one fused
    multiply-add (``_fusions``)."""
    B, S = jp.shape[0], ctx["S"]
    arrs = ctx["arrs"]
    p = _per_lane(ctx["prog"], jp.unsqueeze(1)).squeeze(1)
    jd = _draw_cols(ctx, jp.unsqueeze(1))
    col = lambda x: x.gather(1, jd).squeeze(1)  # noqa: E731
    fail = col(ctx["fail"])
    if is_retry:
        first_fail = torch.zeros_like(fail)
        factor = col(ctx["slow"])
    else:
        first_fail = fail if retries else torch.zeros_like(fail)
        scale = (torch.where(fail, ctx["fv3"], 1.0) if retries
                 else torch.where(fail, 1.0 + ctx["fv3"], 1.0))
        factor = col(ctx["slow"]) * scale
    ct = CT.gather(1, p.view(B, 1, 1, 1).expand(B, 1, S, 2)).squeeze(1)
    runs_row = runs.gather(1, p.view(B, 1, 1).expand(B, 1, S)).squeeze(1)
    need_row = arrs["n_req"][p]                                  # [B, S]
    tt = ctx["tt"]
    Tdur = (tt["T"][p] if ctx["tiered"] else arrs["T_true"][p]) \
        * factor.view((B,) + (1,) * (2 if ctx["tiered"] else 1))
    avail = _earliest_fit(ctx, need_row, t0, Tdur, node_free, slots)
    rows = (ct[..., 0], ct[..., 1], runs_row, avail, arrs["C_pred"][p],
            arrs["T_pred"][p])
    if ctx["tiered"]:
        rows = _tier_rows(tt, p, *rows, avail_per_tier=True)
    draws = ctx["draws"]
    sel_x = select(ctx["pol"], c_row=rows[0], t_row=rows[1],
                   runs_row=rows[2], avail_row=rows[3], k=col(ctx["K"]),
                   c_pred_row=rows[4], t_pred_row=rows[5],
                   draw=None if draws is None else col(draws))
    sel = sel_x % S if ctx["tiered"] else sel_x
    on_x = lambda x: x.reshape(B, -1).gather(1, sel_x.unsqueeze(1)).squeeze(1)  # noqa: E731
    start, T_act = on_x(avail), on_x(Tdur)
    E_res = ctx["act"][p, sel_x, 1] * factor
    # the reservation's finish: one fused multiply-add where the
    # reference's compiled step computes it so, else a plain add
    fin = (fma(ctx["act"][p, sel_x, 0], factor, start) if fused_fin
           else start + T_act)
    return torch.stack([
        sel.to(F32), start, fin, T_act, E_res,
        need_row.gather(1, sel.unsqueeze(1)).squeeze(1).to(F32),
        ctx["w_flat"][p, sel_x], factor, first_fail.to(F32),
        (sel_x // S).to(F32)], 1)


def make_cons_step(policy: Policy, placer: str | None = None,
                   totals_only: bool = False, retries: bool = False,
                   live: bool = False):
    """Conservative backfilling on the event clock: ``step(ctx, carry,
    horizon) -> (carry, out)`` as ``make_event_step`` (``live`` too).

    Every job is reserved at admission, around all earlier pending
    reservations (``_earliest_fit``: hole-aware, the reservations are
    intervals, not committed to the node-free table), with the tables as
    of admission.  A reservation is realized once the clock reaches its
    start and its nodes are really free (``kth_free_time_rows`` over the
    reserved rows, the kernel on the card) and the cap allows it; under a
    binding cap starts degrade to ``max(reserved, now)``.  A failed first
    attempt (``retries``) is reserved afresh at its failure time."""
    _check_live(live, totals_only)
    Wc = int(policy.window) + 1
    NC = len(CONS_COLS)

    def step(ctx, carry: ConsCarry, horizon: float = BIG):
        J, S, N, B = ctx["J"], ctx["S"], ctx["N"], ctx["B"]
        slot, arrival, prog = ctx["slot"], ctx["arrival"], ctx["prog"]
        outage, capped = ctx["outage"], ctx["capped"]
        (node_free, node_pow, CT, runs, acc, busy, slots, a, now, nbf, peak,
         cdel) = carry
        fuse = _fusions("conservative", ctx["site_lanes"], retries)

        # ---- push: admit and reserve the next arrival if due and room
        size0 = (slots[..., 0] < J).sum(1)
        jp = a.clamp_max(J - 1)
        arr_a = _per_lane(arrival, jp.unsqueeze(1)).squeeze(1)
        do_push = (a < J) & (size0 < Wc) & (arr_a <= now)
        vals = _reserve(ctx, jp, arr_a, False, retries, node_free, slots, CT,
                        runs, fuse["fin"])
        at = do_push.unsqueeze(1) & (slot == size0.clamp_max(Wc - 1)
                                     .unsqueeze(1))
        newv = torch.cat([jp.to(F32).unsqueeze(1), arr_a.unsqueeze(1),
                          ctx["admit_tail"].expand(B, 6), vals], 1)
        slots = torch.where(at.unsqueeze(-1), newv.unsqueeze(1), slots)
        a = a + do_push

        valid = slots[..., 0] < J
        r_start = slots[..., CONS_IX["start"]]
        r_sel = slots[..., CONS_IX["sel"]].long()
        r_need = slots[..., CONS_IX["need"]].long()

        next_evt = torch.minimum(
            _next_event(ctx, node_free, a, now),
            torch.where(valid & (r_start > now.unsqueeze(1)), r_start,
                        BIG).amin(1))

        # ---- realizability on the real table (one kth-free call)
        kth_rows = kth_free_time_rows(node_free, r_sel, r_need, force=placer)
        avail_real = torch.maximum(
            torch.where(valid, slots[..., CONS_IX["t0"]], BIG), kth_rows)
        if outage is not None:
            avail_real = _push_out_of_outage(avail_real, outage[r_sel])
        now1 = now.unsqueeze(1)
        elig_res = valid & (r_start <= now1) & (avail_real <= now1)
        if outage is not None:
            gated = _push_out_of_outage(torch.maximum(r_start, now1),
                                        outage[r_sel])
            elig_res = elig_res & (~capped.unsqueeze(1) | (gated <= now1))

        # ---- power feasibility, the stuck valve (it forces every
        # resource-eligible slot) and the choice
        chosen, placed, ci, new_P, slots, p_now = _gate(
            ctx, slots, CONS_IX["pblock"], node_free, node_pow, now, r_need,
            r_sel, slots[..., CONS_IX["wjob"]], elig_res, elig_res, do_push,
            next_evt, horizon)

        # ---- realize the chosen reservation
        row = slots.gather(1, ci.unsqueeze(-1).expand(B, 1, NC)).squeeze(1)
        r = {name: row[:, i] for i, name in enumerate(CONS_COLS)}
        jj = r["pend"].long().clamp_max(J - 1)
        p = _per_lane(prog, jj.unsqueeze(1)).squeeze(1)
        sel = r["sel"].long()
        need = r["need"].long().clamp_min(1)
        T_act, E_act, fac = r["T"], r["E"], r["fac"]
        start = torch.where(capped, torch.maximum(r["start"], now),
                            r["start"])
        finish = start + T_act
        fail = r["fail"] != 0
        failed_now, final = placed & fail, placed & ~fail
        s0_ci = torch.where(r["rt"] != 0, r["s0"], start)
        wait_step = start - r["t0"]
        P_ci = new_P.gather(1, ci).squeeze(1)

        kth_ci = kth_rows.gather(1, ci).squeeze(1)
        row_idx = sel.view(B, 1, 1).expand(B, 1, N)
        take = _alloc_take(node_free.gather(1, row_idx), kth_ci.view(B, 1),
                           need.view(B, 1)) & placed.view(B, 1, 1)
        _set_row(node_free, node_pow, sel, take, finish,
                 r["wjob"] / need.to(F32))
        fac_tot = r["accF"] + fac if retries else fac
        _table_update(CT, runs, ctx["truth"], S, p, sel, fac_tot, final,
                      fuse["obs"])

        # ---- pop the chosen slot
        keep = (slot < chosen.unsqueeze(1)).unsqueeze(-1)
        slots = torch.where(keep, slots, torch.cat(
            [slots[:, 1:], ctx["cons_fill"].expand(B, 1, NC)], 1))

        if retries:
            # a failed first attempt: a fresh reservation at the failure
            # time, around the table as it now stands
            T_tot, wait_tot = r["accT"] + T_act, r["accW"] + wait_step
            vals2 = _reserve(ctx, jj, finish, True, retries, node_free,
                             slots, CT, runs, fuse["fin"])
            size2 = (slots[..., 0] < J).sum(1, keepdim=True)
            at2 = failed_now.unsqueeze(1) & (slot == size2.clamp_max(Wc - 1))
            newv2 = torch.cat([torch.stack(
                [jj.to(F32), finish, torch.ones_like(finish), T_tot, fac_tot,
                 wait_tot, s0_ci, torch.full_like(finish, BIG)], 1), vals2],
                1)
            slots = torch.where(at2.unsqueeze(-1), newv2.unsqueeze(1), slots)
        else:
            T_tot, wait_tot = T_act, wait_step

        acc, busy, now, nbf, peak, cdel, out = _settle(
            ctx, carry, horizon, totals_only, do_push=do_push,
            next_evt=next_evt, chosen=chosen, placed=placed, final=final,
            jj=jj, sel=sel, sel_x=None if totals_only
            else sel + r["tier"].long() * S, need=need, T_act=T_act,
            E_act=E_act, P_ci=P_ci, pb_ci=r["pblock"], s0=s0_ci,
            finish=finish, wait_tot=wait_tot, T_tot=T_tot, live=live, a=a,
            start=start, p_now=p_now,
            pending=slots[..., 0] if live else None)
        return ConsCarry(node_free, node_pow, CT, runs, acc, busy, slots, a,
                         now, nbf, peak, cdel), out

    return step


class _Record:
    """The full path's per-job outputs, scattered to arrival order as the
    steps produce them (column J takes the steps that finalize nothing):
    attempt energies add up per job, the final attempt sets the rest."""

    def __init__(self, B, J, dev):
        self.E = torch.zeros((B, J + 1), dtype=F32, device=dev)
        self.sel_x = torch.zeros((B, J + 1), dtype=torch.int64, device=dev)
        self.vals = torch.zeros((B, J + 1, 5), dtype=F32, device=dev)

    def lane(self, i: int) -> "_Record":
        """Lane ``i`` as a one-lane record of views: what the steps add to
        the whole record shows in it, and what is copied into it lands
        in the whole record (a session pool's member)."""
        rec = _Record.__new__(_Record)
        rec.E, rec.sel_x, rec.vals = (x[i:i + 1] for x in
                                      (self.E, self.sel_x, self.vals))
        return rec

    def add(self, out):
        j_add, j_fin = out["j_add"].unsqueeze(1), out["j_fin"].unsqueeze(1)
        self.E.scatter_add_(1, j_add, out["E"].unsqueeze(1))
        self.sel_x.scatter_(1, j_fin, out["sel_x"].unsqueeze(1))
        B = j_fin.shape[0]
        self.vals.scatter_(1, j_fin.unsqueeze(-1).expand(B, 1, 5),
                           out["vals"].unsqueeze(1))


def _event_results(ctx, carry, rec) -> dict:
    """The result fields from the final carry and, on the full path, the
    recorded per-job channels (``rec`` None with ``totals_only``)."""
    arrs, S, J = ctx["arrs"], ctx["S"], ctx["J"]
    tabs = {"C_tab": carry.CT[..., 0], "T_tab": carry.CT[..., 1],
            "runs": carry.runs, "n_backfilled": carry.nbf}
    busy = carry.busy
    if rec is None:
        sums, _, fin_max, wait_max = carry.acc
        return {"total_energy": sums[:, 0], "makespan": fin_max,
                "total_wait": sums[:, 1], "slowdown_sum": sums[:, 2],
                "max_wait": wait_max, "busy": busy,
                **_power_totals(arrs, fin_max, busy, carry.peak, carry.cdel),
                **tabs}
    sel_x = rec.sel_x[:, :J]
    sel = sel_x % S if ctx["tiered"] else sel_x
    # laid out as the arrival cores lay them out, so that the sums over
    # jobs add alike: (T, E) pairs, the rest contiguous
    start, finish, wait, T_act, bf = (
        x.contiguous() for x in rec.vals[:, :J].unbind(-1))
    T_act, E = torch.stack([T_act, rec.E[:, :J]], -1).unbind(-1)
    makespan = finish.amax(-1)
    return {
        "system": sel.to(torch.int32), "start": start, "finish": finish,
        "wait": wait, "energy": E, "runtime": T_act,
        "nodes": arrs["n_req"][ctx["prog"].expand_as(sel), sel],
        "tier": (sel_x // S).to(torch.int32), "backfilled": bf != 0,
        "total_energy": E.sum(-1), "makespan": makespan,
        "total_wait": wait.sum(-1), "max_wait": wait.amax(-1),
        "slowdown_sum": ((wait + T_act) / T_act).sum(-1), "busy": busy,
        **_power_totals(arrs, makespan, busy, carry.peak, carry.cdel),
        **tabs,
    }


def _event_run(arrs: dict, w: Workload, policy: Policy, lanes: dict, *,
               warm_start: bool, placer, totals_only: bool,
               retries: bool = False, chunk=None) -> dict:
    """Step every lane through the event core for ``policy.queue`` (the
    conservative core, or FCFS / EASY on the event clock) for the static
    ``step_count``, in chunks of ``chunk`` steps, and return the result
    fields with a leading [B]."""
    ctx = event_context(arrs, w, policy, lanes, warm_start, placer)
    cons = policy.queue == "conservative"
    step = (make_cons_step if cons else make_event_step)(
        policy, placer, totals_only, retries)
    carry = (cons_carry0 if cons else event_carry0)(ctx, totals_only)
    rec = None if totals_only else _Record(ctx["B"], ctx["J"], ctx["dev"])
    for _, n in _chunks(step_count(w, policy, retries), chunk):
        if chunk is not None:
            pending = carry.slots[..., 0].long() if cons else carry.pend
            nxt = carry.a.unsqueeze(1) + torch.arange(n, device=ctx["dev"])
            ctx["ids"] = _window_ids(pending, nxt, ctx["J"])
        ctx.update(_job_draws(ctx, ctx.get("ids")))
        for _ in range(n):
            carry, out = step(ctx, carry, BIG)
            if rec is not None:
                rec.add(out)
    return _event_results(ctx, carry, rec)
