"""Arrival-indexed campaign engine on torch tensors (FCFS and batched
EASY backfilling), and the ``Scheduler`` facade, which also routes onto
the event-granular cores of ``core/events.py``.

Models the paper's SCC: several computing systems, each a pool of
interchangeable nodes with per-node free times, and a global job queue
routed by a ``Policy``.  ``Scheduler.run`` flattens the (fault x policy x
seed) grid into one leading lane dimension ``[B]`` and steps every lane
through the job stream together, one job per step:

  1. ask every system when ``n_req`` of its nodes are next free (the
     kth-free radix select, ``kernels/kth_free``: the CUDA kernel on the
     card, its torch twin on the CPU), floored at the arrival and pushed
     out of any open maintenance window;
  2. pick a system (and DVFS tier) with the policy's selector;
  3. allocate the earliest-free nodes, apply the fault factor, update the
     learned C/T tables and the running totals.

The step has no host synchronisation: job data comes from the host-side
workload, every per-lane quantity stays on the device, and selection is
branchless.  Fault factors and ``random``-objective picks are drawn for
all ``[B, J]`` before the loop (threefry is counter based, so the bits
equal the reference's per-step draws).  Per-job outputs go to
preallocated ``[B, J]`` tensors.  ``queue="easy_backfill"`` runs the
windowed EASY core (``_easy_run``): J + W steps, at most one placement
each, with the same per-job placement arithmetic.  Conservative queues,
finite power caps and ``engine="events"`` run on the event-granular cores
(``core/events.py``), as in the reference.

Requests outside the port raise ``NotImplementedError`` naming the
ROADMAP item that brings them: ``easy_eval="unrolled"`` (item 15),
``shards=`` and ``chunk=`` (item 7).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core.dvfs import npb_phase_split, phase_split, tier_tables
from repro_torch.core.policy import (BIG, Policy, _host, apply_queue_spec,
                                     make_policy, select, select_batched)
from repro_torch.core.result import CampaignResult, SimResult
from repro_torch.core.workload_model import NPB_PROFILES, npb_tables
from repro_torch.device import resolve_device
from repro_torch.kernels.kth_free.ops import (check_mode, kth_free_time,
                                              kth_free_time_shared)
from repro_torch.utils import prng
from repro_torch.utils.fp import fma

F32 = torch.float32


@dataclass(frozen=True)
class FaultConfig:
    """One point of a fault grid."""
    straggler_prob: float = 0.0
    straggler_factor: float = 2.0
    failure_prob: float = 0.0
    restart_overhead: float = 0.5


@dataclass(frozen=True)
class Workload:
    """Static description of a job stream over P programs x S systems
    (host numpy arrays; the engine moves them to its device)."""
    prog: np.ndarray            # [J] int32 program ids
    arrival: np.ndarray         # [J] f32 submit times
    k_job: np.ndarray           # [J] f32 per-job K (fraction); NaN -> global k
    n_req: np.ndarray           # [P, S] nodes needed
    T_true: np.ndarray          # [P, S] runtime ground truth
    C_true: np.ndarray          # [P, S] J/Mop ground truth
    E_true: np.ndarray          # [P, S] Joules ground truth
    T_pred: np.ndarray          # [P, S] phase-model predictions
    C_pred: np.ndarray
    n_nodes: np.ndarray         # [S] node counts
    programs: tuple = ()        # names, for reports
    systems: tuple = ()
    # [S, W, 2] maintenance windows (start, end), sorted, non-overlapping
    # per system; None = no outages
    outage: np.ndarray | None = None
    # [S] per-node idle watts; None = 0 W
    idle_w: np.ndarray | None = None
    # [P, S] compute-phase seconds / dynamic compute joules (DVFS model);
    # None = dvfs.phase_split defaults
    T_comp: np.ndarray | None = None
    E_comp: np.ndarray | None = None


def make_npb_workload(systems, order=("BT", "EP", "IS", "LU", "SP"),
                      arrivals=None, k_job=None, repeats: int = 1,
                      pred_noise: float = 0.0, noise_seed: int = 0,
                      outage=None):
    """The paper's experiment: NPB suite submitted (simultaneously by
    default) to the given systems. ``repeats`` re-submits the suite."""
    programs = tuple(sorted(set(order)))
    pidx = {p: i for i, p in enumerate(programs)}
    C, T, N = npb_tables(systems, programs)
    mops = np.array([NPB_PROFILES[p].flops / 1e6 for p in programs])
    E = C * mops[:, None]
    rng = np.random.default_rng(noise_seed)
    noise = (1.0 + pred_noise * rng.standard_normal(C.shape)) if pred_noise else 1.0
    seq = list(order) * repeats
    J = len(seq)
    T_comp, E_comp = npb_phase_split(systems, programs, N)
    return Workload(
        prog=np.array([pidx[p] for p in seq], np.int32),
        arrival=np.zeros(J, np.float32) if arrivals is None
        else np.asarray(arrivals, np.float32),
        k_job=np.full(J, np.nan, np.float32) if k_job is None
        else np.asarray(k_job, np.float32),
        n_req=N, T_true=T, C_true=C, E_true=E,
        T_pred=T * noise, C_pred=C * noise,
        n_nodes=np.array([s.n_nodes for s in systems], np.int32),
        programs=programs, systems=tuple(s.name for s in systems),
        outage=None if outage is None else np.asarray(outage, np.float32),
        idle_w=np.array([s.idle_w for s in systems], np.float32),
        T_comp=T_comp, E_comp=E_comp,
    )


def _fault_draws(fault_key, J: int, fvecs):
    """Deterministic straggler factor [B, J] f32 and failure flag [B, J]
    bool of every job in every lane.  fault_key: [B, 2]; fvecs: [B, 4] =
    (straggler_prob, straggler_factor, failure_prob, restart_overhead)."""
    jj = torch.arange(J, device=fault_key.device)
    u = prng.uniform(prng.fold_in(fault_key[:, None, :], jj), (2,))
    fv = fvecs[:, None, :]
    slow = torch.where(u[..., 0] < fv[..., 0], fv[..., 1], 1.0)
    return slow, u[..., 1] < fv[..., 2]


def _fault_factors(slow, fail, fvecs):
    """The contiguous fault model's factor per job, [B, J]: a failing job
    re-does ``restart_overhead`` of its work in one placement."""
    return slow * torch.where(fail, 1.0 + fvecs[:, 3:], 1.0)


def _workload_arrays(w: Workload, device) -> dict:
    """Workload -> the device tensors the engine consumes."""
    f32 = lambda x: torch.as_tensor(np.asarray(x), device=device).to(F32)
    max_n = int(w.n_nodes.max())
    node_exists = np.arange(max_n)[None, :] < w.n_nodes[:, None]   # [S, maxN]
    arrs = {
        "free0": torch.where(torch.as_tensor(node_exists, device=device),
                             0.0, BIG).to(F32),
        "n_req": torch.as_tensor(np.asarray(w.n_req, np.int32),
                                 device=device),
        "T_true": f32(w.T_true), "C_true": f32(w.C_true),
        "E_true": f32(w.E_true), "T_pred": f32(w.T_pred),
        "C_pred": f32(w.C_pred),
        # per-job average draw E/T (paper eq. 1-2), per-system idle watts
        "w_pow": f32(w.E_true / np.maximum(w.T_true, 1e-30)),
        "idle_w": torch.zeros(len(w.n_nodes), dtype=F32, device=device)
        if w.idle_w is None else f32(w.idle_w),
    }
    T_comp, E_comp = phase_split(w)
    arrs["T_comp"], arrs["E_comp"] = f32(T_comp), f32(E_comp)
    if w.outage is not None and w.outage.size:
        arrs["outage"] = f32(w.outage)
    return arrs


def _push_out_of_outage(avail, outage):
    """Earliest start per system, pushed past any open maintenance window
    (windows sorted per system, so one in-order pass resolves cascades).
    ``outage`` is [S, W0, 2] against ``avail``'s last (system) dimension,
    or any [..., W0, 2] whose leading dimensions broadcast with it."""
    for wi in range(outage.shape[-2]):
        o0, o1 = outage[..., wi, 0], outage[..., wi, 1]
        avail = torch.where((avail >= o0) & (avail < o1), o1, avail)
    return avail


def _earliest(node_free, nreq, arr: float, placer, outage):
    """(kth free time, earliest start) per lane and system for one job:
    the kth-free radix select, floored at the arrival and pushed out of
    any open maintenance window."""
    kth = kth_free_time(node_free, nreq, force=placer)
    avail = kth.clamp_min(arr)
    if outage is not None:
        avail = _push_out_of_outage(avail, outage)
    return kth, avail


def _alloc_row(row, kth_sel, need, finish):
    """A node-free row [..., N] after an allocation: the nodes strictly
    below the kth free time plus first-by-index ties at it, until
    ``finish``.  kth_sel/need/finish: [...]."""
    kth = kth_sel.unsqueeze(-1)
    below = row < kth
    tie = row == kth
    tie_rank = tie.cumsum(-1) - 1
    room = (need - below.sum(-1)).unsqueeze(-1)
    take = below | (tie & (tie_rank < room))
    return torch.where(take, finish.unsqueeze(-1), row)


def _alloc_(node_free, sel, kth_sel, need, finish):
    """In place: every lane allocates on its system ``sel`` (``_alloc_row``).
    node_free [B, S, N]; sel/kth_sel/need/finish [B]."""
    B, _, N = node_free.shape
    idx = sel.view(B, 1, 1).expand(B, 1, N)
    row = node_free.gather(1, idx).squeeze(1)                    # [B, N]
    node_free.scatter_(1, idx, _alloc_row(row, kth_sel, need,
                                          finish).unsqueeze(1))


def _idle_energy(arrs, makespan, busy):
    """Idle draw of unallocated existing nodes over the makespan (Joules):
    the complement of the job-attributed energy."""
    idle_w = arrs["idle_w"]                                      # [S]
    n_exist = (arrs["free0"] < BIG).sum(1).to(F32)               # [S]
    return fma(_dot(idle_w, n_exist), makespan, -_dot(idle_w, busy))


def _dot(a, b):
    """Sum over the last (system) axis of ``a * b`` as the reference's
    compiled reduction computes it: a fused multiply-add chain in index
    order."""
    acc = torch.zeros_like(b[..., 0])
    for s in range(b.shape[-1]):
        acc = fma(a[..., s], b[..., s], acc)
    return acc


def _power_totals(arrs, makespan, busy, peak=None, cdel=None):
    """The SCC power fields of every result.  The arrival-indexed scans
    track no cluster power trace: ``peak_power`` NaN and ``capped_delay``
    zero; the event cores pass their running peak and delay."""
    return {"peak_power": (torch.full_like(makespan, math.nan)
                           if peak is None else peak),
            "capped_delay": (torch.zeros_like(makespan)
                             if cdel is None else cdel),
            "idle_energy": _idle_energy(arrs, makespan, busy)}


def _tier_rows(tt, p, C_row, T_row, runs_row, avail_row, C_pred_row,
               T_pred_row, avail_per_tier: bool = False):
    """Expand one job's [B, S] selection rows (or an EASY window's [B, W,
    S], with ``p`` [B, W]) over the (tier x system) candidate axis,
    tier-major (flat index f * S + s, tier 0 first).  ``avail_per_tier``:
    ``avail_row`` is already per (tier, system), [..., F, S] (the
    conservative core's per-tier earliest fit), and is only flattened."""
    rc, rt = tt["rc"][p], tt["rt"][p]                            # [..., F, S]
    F, S = rc.shape[-2:]
    flat = lambda x: x.reshape(x.shape[:-2] + (F * S,))
    tile = lambda x: flat(x.unsqueeze(-2).expand(x.shape[:-1] + (F, S)))
    return (flat(C_row.unsqueeze(-2) * rc), flat(T_row.unsqueeze(-2) * rt),
            tile(runs_row),
            flat(avail_row) if avail_per_tier else tile(avail_row),
            flat(C_pred_row.unsqueeze(-2) * rc),
            flat(T_pred_row.unsqueeze(-2) * rt))


def _setup(arrs: dict, w: Workload, policy: Policy, lanes: dict,
           warm_start: bool) -> dict:
    """What every core builds before its step loop: the per-program
    tables gathered at a chosen candidate, the [B, J] fault factors (and
    their straggler and failure parts, which the event cores use apart),
    ``random`` draws and effective K, the per-lane policy, and the
    initial node-free and learned tables."""
    dev = arrs["free0"].device
    T_true, C_true, E_true = arrs["T_true"], arrs["C_true"], arrs["E_true"]
    P, S = T_true.shape
    N = arrs["free0"].shape[-1]
    J = len(w.prog)
    B = lanes["k"].shape[0]
    tiered = policy.tiered
    tt = tier_tables(arrs, policy.freq_tiers) if tiered else None
    FS = len(policy.freq_tiers) * S
    sel_key, fault_key = prng.split(prng.key(lanes["seed"])).unbind(1)
    slow, fail = _fault_draws(fault_key, J, lanes["fvec"])
    draws = None
    if policy.objective == "random":
        jj = torch.arange(J, device=dev)
        draws = prng.randint(prng.fold_in(sel_key[:, None, :], jj), (), 0,
                             FS)                                 # [B, J]
    kjob = torch.as_tensor(np.asarray(w.k_job, np.float32), device=dev)
    truth = torch.stack([C_true, T_true], -1)                    # [P, S, 2]
    if warm_start:
        CT = truth.expand(B, P, S, 2).clone()
        runs = torch.ones((B, P, S), dtype=torch.int32, device=dev)
    else:
        CT = torch.zeros((B, P, S, 2), dtype=F32, device=dev)
        runs = torch.zeros((B, P, S), dtype=torch.int32, device=dev)
    return dict(
        dev=dev, P=P, S=S, N=N, J=J, B=B, tiered=tiered, tt=tt, FS=FS,
        # base (C, T) for the learned tables, realized (T, E) for the job
        # (tier-major when tiered, matching the selector's flat index)
        truth=truth,
        act=(torch.stack([tt["T"], tt["E"]], -1).reshape(P, FS, 2)
             if tiered else torch.stack([T_true, E_true], -1)),
        factor=_fault_factors(slow, fail, lanes["fvec"]),        # [B, J]
        slow=slow, fail=fail,
        draws=draws,
        K=torch.where(torch.isnan(kjob), lanes["k"][:, None], kjob),
        pol=replace(policy, ucb_scale=lanes["ucb_scale"],
                    freq_weight=lanes["freq_weight"]),
        node_free=arrs["free0"].expand(B, S, N).clone(), CT=CT, runs=runs)


def _kahan(sums, comps, add):
    """One Kahan-compensated f32 step of the running sums (the
    reference's ``totals_only`` path): the new ``(sums, comps)``."""
    y = add - comps
    t = sums + y
    return t, (t - sums) - y


def _totals(arrs, sums, fin_max, wait_max, busy, tabs) -> dict:
    """The result fields of a ``totals_only`` run."""
    return {"total_energy": sums[:, 0], "makespan": fin_max,
            "total_wait": sums[:, 1], "slowdown_sum": sums[:, 2],
            "max_wait": wait_max, "busy": busy,
            **_power_totals(arrs, fin_max, busy), **tabs}


def _arrival_run(arrs: dict, w: Workload, policy: Policy, lanes: dict, *,
                 warm_start: bool, placer, totals_only: bool) -> dict:
    """Step every lane through the job stream (one job per step) and
    return the result fields with a leading [B] dimension."""
    st = _setup(arrs, w, policy, lanes, warm_start)
    dev, S, J, B = st["dev"], st["S"], st["J"], st["B"]
    tiered, tt, truth, act = st["tiered"], st["tt"], st["truth"], st["act"]
    factor, draws, K, pol = st["factor"], st["draws"], st["K"], st["pol"]
    node_free, CT, runs = st["node_free"], st["CT"], st["runs"]
    P = st["P"]
    prog_h = np.asarray(w.prog)
    arrival_h = np.asarray(w.arrival, np.float32)
    outage = arrs.get("outage")
    nreq_b = arrs["n_req"].unsqueeze(1).expand(P, B, S).contiguous()

    one = torch.ones((B, 1), dtype=torch.int32, device=dev)
    # busy node-seconds per system, accumulated in job order as the
    # reference's scatter-add does (one add per lane and step)
    busy = torch.zeros((B, S), dtype=F32, device=dev)
    if totals_only:
        sums = torch.zeros((B, 3), dtype=F32, device=dev)
        comps = torch.zeros((B, 3), dtype=F32, device=dev)
        fin_max = torch.zeros(B, dtype=F32, device=dev)
        wait_max = torch.zeros(B, dtype=F32, device=dev)
    else:
        sel_out = torch.empty((B, J), dtype=torch.int64, device=dev)
        start_out = torch.empty((B, J), dtype=F32, device=dev)

    for j in range(J):
        p, arr = int(prog_h[j]), float(arrival_h[j])
        nreq = nreq_b[p]                                         # [B, S]
        kth, avail = _earliest(node_free, nreq, arr, placer, outage)
        ct = CT[:, p]                                            # [B, S, 2]
        rows = (ct[..., 0], ct[..., 1], runs[:, p], avail,
                arrs["C_pred"][p], arrs["T_pred"][p])
        if tiered:
            rows = _tier_rows(tt, p, *rows)
        c_r, t_r, r_r, a_r, cp_r, tp_r = rows
        sel_x = select(pol, c_row=c_r, t_row=t_r, runs_row=r_r,
                       avail_row=a_r, k=K[:, j], c_pred_row=cp_r,
                       t_pred_row=tp_r,
                       draw=None if draws is None else draws[:, j])
        sel = sel_x % S if tiered else sel_x
        sel1 = sel.unsqueeze(1)                                  # [B, 1]

        fac = factor[:, j]
        ac = act[p][sel_x]                                       # [B, 2]
        start = avail.gather(1, sel1).squeeze(1)
        idx2 = sel1.unsqueeze(-1).expand(B, 1, 2)
        old = ct.gather(1, idx2).squeeze(1)                      # [B, 2]
        n = runs[:, p].gather(1, sel1).to(F32)                   # [B, 1]
        upd = truth[p][sel] * fac.unsqueeze(1)                   # C_act, T_upd
        # one fused multiply-add each, as the reference computes them:
        # finish = T * factor + start, table = old * n + observation
        fused = fma(torch.cat([old, ac[:, :1]], 1),
                    torch.cat([n, n, fac.unsqueeze(1)], 1),
                    torch.cat([upd, start.unsqueeze(1)], 1))
        finish = fused[:, 2]
        need = nreq.gather(1, sel1).squeeze(1)
        _alloc_(node_free, sel, kth.gather(1, sel1).squeeze(1), need, finish)
        ct.scatter_(1, idx2, (fused[:, :2] / (n + 1)).unsqueeze(1))
        runs[:, p].scatter_add_(1, sel1, one)
        T_act, E_act = (ac * fac.unsqueeze(1)).unbind(1)
        busy.scatter_add_(1, sel1, (T_act * need).unsqueeze(1))

        if totals_only:
            wait = start - arr
            sums, comps = _kahan(sums, comps, torch.stack(
                [E_act, wait, (wait + T_act) / T_act], 1))
            fin_max = torch.maximum(fin_max, finish)
            wait_max = torch.maximum(wait_max, wait)
        else:
            sel_out[:, j] = sel_x
            start_out[:, j] = start

    tabs = {"C_tab": CT[..., 0], "T_tab": CT[..., 1], "runs": runs,
            "n_backfilled": torch.zeros(B, dtype=torch.int32, device=dev)}
    if totals_only:
        return _totals(arrs, sums, fin_max, wait_max, busy, tabs)

    return _job_results(arrs, st, w, sel_out, start_out, tabs, busy=busy,
                        fused_finish=True)


def _job_results(arrs, st, w, sel_out, start, tabs, *, busy=None,
                 fused_finish: bool, backfilled=None) -> dict:
    """The full path's result fields from each job's candidate index
    ``sel_out`` and start [B, J], recomputed with the step's own
    elementwise ops (so the bits equal the step's).  ``finish`` is one
    fused multiply-add where the core's step fuses it (FCFS) and a plain
    add where it does not (EASY).  ``busy=None`` accumulates the busy
    node-seconds here, in job order as the reference's scatter-add."""
    dev, S, J, B = st["dev"], st["S"], st["J"], st["B"]
    factor = st["factor"]
    prog = torch.as_tensor(np.asarray(w.prog).astype(np.int64),
                           device=dev).expand(B, J)
    sel = sel_out % S if st["tiered"] else sel_out
    ac = st["act"][prog, sel_out]                                # [B, J, 2]
    T_act, E_act = (ac * factor.unsqueeze(-1)).unbind(-1)
    finish = fma(ac[..., 0], factor, start) if fused_finish \
        else start + T_act
    wait = start - torch.as_tensor(np.asarray(w.arrival, np.float32),
                                   device=dev)
    nodes = arrs["n_req"][prog, sel]
    if busy is None:
        busy = torch.zeros((B, S), dtype=F32, device=dev)
        work = T_act * nodes
        for j in range(J):
            busy.scatter_add_(1, sel[:, j:j + 1], work[:, j:j + 1])
    makespan = finish.amax(-1)
    return {
        "system": sel.to(torch.int32), "start": start, "finish": finish,
        "wait": wait, "energy": E_act, "runtime": T_act, "nodes": nodes,
        "tier": (sel_out // S).to(torch.int32),
        "backfilled": (torch.zeros((B, J), dtype=torch.bool, device=dev)
                       if backfilled is None else backfilled),
        "total_energy": E_act.sum(-1), "makespan": makespan,
        "total_wait": wait.sum(-1), "max_wait": wait.amax(-1),
        "slowdown_sum": ((wait + T_act) / T_act).sum(-1), "busy": busy,
        **_power_totals(arrs, makespan, busy), **tabs,
    }


def _earliest_shared(node_free, nreq_rows, arr_col, placer, outage):
    """``_earliest`` for a whole EASY window against ONE node-free table
    per lane: [B, W, S] requests -> ([B, W, S] kth, [B, W, S] earliest
    start), through the shared-table entry.  ``arr_col``: [B, W, 1]."""
    kth = kth_free_time_shared(node_free, nreq_rows, force=placer)
    avail = torch.maximum(kth, arr_col)
    if outage is not None:
        avail = _push_out_of_outage(avail, outage)
    return kth, avail


def _easy_run(arrs: dict, w: Workload, policy: Policy, lanes: dict, *,
              warm_start: bool, placer, totals_only: bool) -> dict:
    """EASY backfilling over a bounded pending window: J + W steps, every
    lane in step, and the result fields with a leading [B] dimension.

    Each lane keeps a pending buffer of W + 1 job ids (arrival order,
    padded with the sentinel J).  A step pushes the arriving job (the W
    drain steps push the sentinel with ``now = BIG``) and places at most
    one job: the head when the window is full (forced) or when its
    reserved start ``r_h`` is <= ``now``; else the first pending job whose
    trial allocation does not push the head's earliest start on its
    reserved system past ``r_h``; else none.

    Every slot is scored against the SAME node-free table: one
    shared-table kth-free call over [B, W + 1, S] requests, one batched
    ``select``, one trial allocation per slot on its chosen row.  The
    no-delay guard needs only the head's reserved system, so one kth-free
    call over each trial's row of it, [B, W + 1, maxN], rechecks every
    slot at once.  These two calls are the step's only kernel launches;
    ``chosen``, ``placed`` and the buffer stay on the device (no host
    synchronisation).  Sentinel slots evaluate job J - 1 and are masked.
    Per-job outputs are scattered to arrival order as they are placed."""
    st = _setup(arrs, w, policy, lanes, warm_start)
    dev, P, S, N, J, B = (st[k] for k in ("dev", "P", "S", "N", "J", "B"))
    tiered, tt, truth, act = st["tiered"], st["tt"], st["truth"], st["act"]
    factor, draws, K, pol = st["factor"], st["draws"], st["K"], st["pol"]
    node_free, CT, runs = st["node_free"], st["CT"], st["runs"]
    W = int(policy.window)
    Wc = W + 1
    outage = arrs.get("outage")
    n_req = arrs["n_req"]
    C_pred, T_pred = arrs["C_pred"], arrs["T_pred"]
    arrival_h = np.asarray(w.arrival, np.float32)
    prog = torch.as_tensor(np.asarray(w.prog).astype(np.int64), device=dev)
    arrival = torch.as_tensor(arrival_h, device=dev)
    # the head recheck's kth-free mode: every mode is bit-exact, so absent
    # a placer the kernel on the card and one sort on the CPU
    recheck = placer or ("cuda" if node_free.is_cuda else "sort")
    fuse_obs = tiered or B == 1

    slot = torch.arange(Wc, device=dev)
    pend = torch.full((B, Wc), J, dtype=torch.int64, device=dev)
    sentinel = pend[:, :1].clone()
    no = torch.zeros(B, dtype=torch.bool, device=dev)
    nbf = torch.zeros(B, dtype=torch.int32, device=dev)
    CT_flat = CT.view(B, P * S, 2)
    runs_flat = runs.view(B, P * S)
    if totals_only:
        # busy node-seconds in placement order, as the reference's
        # totals_only step adds them
        busy = torch.zeros((B, S), dtype=F32, device=dev)
        sums = torch.zeros((B, 3), dtype=F32, device=dev)
        comps = torch.zeros((B, 3), dtype=F32, device=dev)
        fin_max = torch.zeros(B, dtype=F32, device=dev)
        wait_max = torch.zeros(B, dtype=F32, device=dev)
    else:
        # column J takes the steps that place nothing
        sel_out = torch.zeros((B, J + 1), dtype=torch.int64, device=dev)
        start_out = torch.zeros((B, J + 1), dtype=F32, device=dev)
        bf_out = torch.zeros((B, J + 1), dtype=torch.bool, device=dev)

    for t in range(J + W):
        # push the arrival into the first sentinel slot (size <= W at step
        # start keeps it in range); a full window forces the head
        if t < J:
            size0 = (pend < J).sum(1, keepdim=True)              # [B, 1]
            pend.scatter_(1, size0.clamp_max(Wc - 1), t)
            forced = size0.squeeze(1) == W
            now = float(arrival_h[t])
        else:
            forced, now = no, BIG
        head_valid = pend[:, 0] < J

        # score every slot against the same node-free table
        jjs = pend.clamp_max(J - 1)                              # [B, Wc]
        ps = prog[jjs]
        nreq_rows = n_req[ps]                                    # [B, Wc, S]
        kths, avails = _earliest_shared(node_free, nreq_rows,
                                        arrival[jjs].unsqueeze(-1), placer,
                                        outage)
        ct = CT.gather(1, ps[..., None, None].expand(B, Wc, S, 2))
        rows = (ct[..., 0], ct[..., 1],
                runs.gather(1, ps.unsqueeze(-1).expand(B, Wc, S)), avails,
                C_pred[ps], T_pred[ps])
        if tiered:
            rows = _tier_rows(tt, ps, *rows)
        c_r, t_r, r_r, a_r, cp_r, tp_r = rows
        sels_x = select_batched(
            pol, c_rows=c_r, t_rows=t_r, runs_rows=r_r, avail_rows=a_r,
            k=K.gather(1, jjs), c_pred_rows=cp_r, t_pred_rows=tp_r,
            draws=None if draws is None else draws.gather(1, jjs))
        sels = sels_x % S if tiered else sels_x                  # [B, Wc]
        factors = factor.gather(1, jjs)
        on_sel = lambda x: x.gather(-1, sels.unsqueeze(-1)).squeeze(-1)  # noqa: E731
        starts = on_sel(avails)
        T_acts = act[ps, sels_x, 0] * factors
        needs = on_sel(nreq_rows)
        # each slot's trial allocation, on its own chosen row
        trials = _alloc_row(
            node_free.gather(1, sels.unsqueeze(-1).expand(B, Wc, N)),
            on_sel(kths), needs, starts + T_acts)                # [B, Wc, N]

        # the no-delay guard for every slot at once: a trial can delay
        # the head only on the head's reserved system sel_h, so recheck
        # each trial's row of it (untouched rows give r_h back exactly)
        sel_h = sels[:, 0]
        head_row = node_free.gather(1, sel_h.view(B, 1, 1).expand(B, 1, N))
        trial_h = torch.where((sels == sel_h.unsqueeze(1)).unsqueeze(-1),
                              trials, head_row)                  # [B, Wc, N]
        kth_h2 = kth_free_time(trial_h, needs[:, :1].expand(B, Wc),
                               force=recheck)
        avail_h2 = torch.maximum(kth_h2, arrival[jjs[:, :1]])
        if outage is not None:
            avail_h2 = _push_out_of_outage(avail_h2,
                                           outage[sel_h].unsqueeze(1))
        r_h = starts[:, 0]                                       # reservation
        place_head = head_valid & (forced | (r_h <= now))

        # first fit: the least eligible slot index (Wc = none)
        elig = torch.where(
            slot == 0, place_head.unsqueeze(1),
            (head_valid & ~place_head).unsqueeze(1) & (pend < J)
            & (avail_h2 <= r_h.unsqueeze(1)))
        chosen = torch.where(elig, slot, Wc).amin(1)             # [B]
        placed = chosen < Wc
        ci = chosen.clamp_max(Wc - 1).unsqueeze(1)               # [B, 1]
        pick = lambda x: x.gather(1, ci).squeeze(1)  # noqa: E731
        sel_x, sel, p = pick(sels_x), pick(sels), pick(ps)
        fac, T_act, start, need = (pick(factors), pick(T_acts),
                                   pick(starts), pick(needs))
        jj = pick(jjs)

        # the chosen trial row IS the placement
        row_idx = sel.view(B, 1, 1).expand(B, 1, N)
        node_free.scatter_(1, row_idx, torch.where(
            placed.view(B, 1, 1),
            trials.gather(1, ci.unsqueeze(-1).expand(B, 1, N)),
            node_free.gather(1, row_idx)))
        # the learned tables absorb base observations, old * n + truth *
        # factor, with the product the reference's compiled step fuses
        # (read from its CPU machine code): truth * factor under DVFS
        # tiers or with a single lane, else old * n
        flat = (p * S + sel).unsqueeze(1)                        # [B, 1]
        flat2 = flat.unsqueeze(-1).expand(B, 1, 2)
        old = CT_flat.gather(1, flat2).squeeze(1)                # [B, 2]
        n = runs_flat.gather(1, flat).to(F32)                    # [B, 1]
        obs = truth[p, sel]                                      # C, T true
        tot = (fma(obs, fac.unsqueeze(1), old * n) if fuse_obs
               else fma(old, n, obs * fac.unsqueeze(1)))
        CT_flat.scatter_(1, flat2, torch.where(
            placed.unsqueeze(1), tot / (n + 1), old).unsqueeze(1))
        runs_flat.scatter_add_(1, flat, placed.to(torch.int32).unsqueeze(1))
        backfill = placed & (chosen > 0)
        nbf += backfill.to(torch.int32)

        # pop the chosen slot: shift the tail left (chosen == Wc: no-op)
        shifted = torch.cat([pend[:, 1:], sentinel], 1)
        pend = torch.where(slot < chosen.unsqueeze(1), pend, shifted)

        if totals_only:
            E_act = act[p, sel_x, 1] * fac
            finish = start + T_act
            wait = start - arrival[jj]
            add = torch.stack([E_act, wait, (wait + T_act) / T_act], 1)
            sums, comps = _kahan(sums, comps, torch.where(
                placed.unsqueeze(1), add, 0.0))
            fin_max = torch.maximum(fin_max,
                                    torch.where(placed, finish, 0.0))
            busy.scatter_add_(1, sel.unsqueeze(1), torch.where(
                placed, T_act * need, 0.0).unsqueeze(1))
            wait_max = torch.maximum(wait_max,
                                     torch.where(placed, wait, 0.0))
        else:
            j_pl = torch.where(placed, jj, J).unsqueeze(1)
            sel_out.scatter_(1, j_pl, sel_x.unsqueeze(1))
            start_out.scatter_(1, j_pl, start.unsqueeze(1))
            bf_out.scatter_(1, j_pl, backfill.unsqueeze(1))

    tabs = {"C_tab": CT[..., 0], "T_tab": CT[..., 1], "runs": runs,
            "n_backfilled": nbf}
    if totals_only:
        return _totals(arrs, sums, fin_max, wait_max, busy, tabs)
    return _job_results(arrs, st, w, sel_out[:, :J], start_out[:, :J], tabs,
                        fused_finish=False, backfilled=bf_out[:, :J])


def _fault_vec(cfg: FaultConfig) -> list:
    return [cfg.straggler_prob, cfg.straggler_factor, cfg.failure_prob,
            cfg.restart_overhead]


class Scheduler:
    """The entry point: a policy (point or grid), a placement backend,
    optional fault and seed grids, and a device.

    policy:     registered name, or a ``Policy`` (leaf-batch ``k`` /
                ``ucb_scale`` / ``freq_weight`` with a shared leading axis
                to sweep a hyperparameter grid in one run)
    placer:     kth-free dispatch: None (auto: the CUDA kernel on the card,
                the torch twin on the CPU), "cuda", "torch" or "sort"
    faults:     one FaultConfig (no axis) or an iterable (adds a ``fault``
                axis); None = fault-free
    seeds:      one int (no axis) or an iterable (adds a ``seed`` axis)
    warm_start: profile tables pre-filled with ground truth
    queue:      queue-discipline spec overriding the policy's: "fcfs" |
                "easy_backfill[:window=W]" | "conservative[:window=W]"
    easy_eval:  EASY candidate evaluation: "batched" (the only one ported)
    power_cap:  SCC power cap in Watts, a scalar or a 1-D grid that
                batches with ``k`` (overrides the policy's leaf); a finite
                cap runs on the event-granular core
    engine:     None (auto: "events" for conservative queues or finite
                caps, else "arrival"), "arrival" or "events"; "arrival"
                with either is a ``ValueError``.  On the event core a
                fault grid with ``failure_prob > 0`` re-queues failures
    device:     None = CUDA (``RuntimeError`` if absent), or any torch
                device such as "cpu"

    Not ported (``NotImplementedError``): ``easy_eval="unrolled"`` (item
    15), ``shards=`` and ``chunk=`` (item 7).

    ``run(w)`` returns a ``SimResult`` when no axis is present, else a
    ``CampaignResult`` with ``axes`` ordered (fault, policy, seed).
    ``totals_only=True`` keeps the per-job accounting in running sums
    (Kahan-compensated) instead of [*grid, J] outputs.
    """

    def __init__(self, policy: str | Policy = "paper", *,
                 placer: str | None = None, faults=None, seeds=0,
                 warm_start: bool = False, queue: str | None = None,
                 easy_eval: str = "batched", power_cap=None,
                 engine: str | None = None, shards=None, chunk=None,
                 device=None):
        self.policy = make_policy(policy) if isinstance(policy, str) else policy
        if queue is not None:
            self.policy = apply_queue_spec(self.policy, queue)
        if power_cap is not None:
            self.policy = replace(self.policy,
                                  power_cap=np.asarray(power_cap, np.float32))
        if easy_eval not in ("batched", "unrolled"):
            raise ValueError(f"easy_eval {easy_eval!r} not in "
                             "('batched', 'unrolled')")
        if engine not in (None, "arrival", "events"):
            raise ValueError(f"engine {engine!r} not in (None, 'arrival', "
                             "'events')")
        if easy_eval == "unrolled":
            raise NotImplementedError(
                "easy_eval='unrolled' is not ported (ROADMAP Queue 1 item "
                "15); 'batched' gives the same placements")
        if engine == "arrival" and self.policy.queue == "conservative":
            raise ValueError("queue='conservative' requires the event-"
                             "granular core (engine='events' or None)")
        if engine == "arrival" and self.policy.capped:
            raise ValueError("a finite power_cap requires the event-"
                             "granular core (engine='events' or None): the "
                             "arrival-indexed scan cannot defer placements")
        if shards is not None:
            raise NotImplementedError(
                "shards= is not ported yet (ROADMAP Queue 1 item 7, "
                "campaign scale)")
        if chunk is not None:
            raise NotImplementedError(
                "chunk= is not ported yet (ROADMAP Queue 1 item 7, "
                "campaign scale)")
        check_mode(placer)
        self.engine = engine
        self.easy_eval = easy_eval
        self.placer = placer
        self.device = resolve_device(device)
        self.warm_start = bool(warm_start)
        if faults is None or isinstance(faults, FaultConfig):
            self.faults = faults
        else:
            self.faults = tuple(faults)
        self.seeds = seeds if isinstance(seeds, (int, np.integer)) \
            else tuple(int(s) for s in seeds)

    def run(self, w: Workload, *, totals_only: bool = False):
        pol = self.policy
        leaf = lambda x: torch.as_tensor(_host(x)).to(F32)
        k, u, pc, fw = (leaf(pol.k), leaf(pol.ucb_scale),
                        leaf(pol.power_cap), leaf(pol.freq_weight))
        if max(x.dim() for x in (k, u, pc, fw)) > 1:
            raise ValueError("policy leaves must be scalars or 1-D grids; "
                             "flatten K x ucb meshes with .ravel()")
        has_policy_axis = any(x.dim() == 1 for x in (k, u, pc, fw))
        k, u, pc, fw = torch.broadcast_tensors(
            *(torch.atleast_1d(x) for x in (k, u, pc, fw)))
        G = k.shape[0]

        has_seed_axis = not isinstance(self.seeds, (int, np.integer))
        seeds = torch.atleast_1d(torch.as_tensor(self.seeds,
                                                 dtype=torch.int32))
        R = seeds.shape[0]

        has_fault_axis = isinstance(self.faults, tuple)
        if self.faults is None:
            fmat = torch.tensor([_fault_vec(FaultConfig())], dtype=F32)
        elif has_fault_axis:
            fmat = torch.tensor([_fault_vec(f) for f in self.faults],
                                dtype=F32)
        else:
            fmat = torch.tensor([_fault_vec(self.faults)], dtype=F32)
        F = fmat.shape[0]

        B = F * G * R
        lane = lambda x: x[None, :, None].expand(F, G, R).reshape(B)
        dev = self.device
        lanes = {"k": lane(k), "ucb_scale": lane(u),
                 "freq_weight": lane(fw), "power_cap": lane(pc),
                 "seed": seeds[None, None, :].expand(F, G, R).reshape(B),
                 "fvec": fmat[:, None, None, :].expand(F, G, R, 4)
                 .reshape(B, 4)}
        lanes = {n: x.to(dev) for n, x in lanes.items()}
        # conservative queues and finite caps need completion events;
        # failures re-queue mid-job on the event clock
        core = self.engine or ("events" if (pol.queue == "conservative"
                                            or pol.capped) else "arrival")
        kw = dict(warm_start=self.warm_start, placer=self.placer,
                  totals_only=totals_only)
        if core == "events":
            # imported here: the event cores import this module
            from repro_torch.core.events import _event_run
            fault_list = (() if self.faults is None else
                          (self.faults,) if not has_fault_axis
                          else self.faults)
            run = _event_run
            kw["retries"] = any(f.failure_prob > 0 for f in fault_list)
        else:
            run = _easy_run if pol.queue == "easy_backfill" else _arrival_run
        out = run(_workload_arrays(w, dev), w, pol, lanes, **kw)

        axes, lead = [], []
        for name, present, size in (("fault", has_fault_axis, F),
                                    ("policy", has_policy_axis, G),
                                    ("seed", has_seed_axis, R)):
            if present:
                axes.append(name)
                lead.append(size)
        out = {n: x.reshape(tuple(lead) + x.shape[1:]) for n, x in out.items()}

        meta = dict(axes=tuple(axes), n_jobs=int(len(w.prog)),
                    n_nodes=np.asarray(w.n_nodes), programs=w.programs,
                    systems=w.systems, freq_tiers=pol.freq_tiers)
        if not axes:
            return SimResult(**out, **meta)
        coords = {}
        if has_fault_axis:
            coords["fault"] = self.faults
        if has_policy_axis:
            coords["policy"] = replace(pol, k=k, ucb_scale=u, power_cap=pc,
                                       freq_weight=fw)
        if has_seed_axis:
            coords["seed"] = self.seeds
        return CampaignResult(**out, **meta, coords=coords)
