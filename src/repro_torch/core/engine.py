"""Arrival-indexed FCFS campaign engine on torch tensors, and the
``Scheduler`` facade.

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
preallocated ``[B, J]`` tensors.

Requests outside this slice raise ``NotImplementedError`` naming the
ROADMAP item that brings them: EASY and conservative queues, finite power
caps, the event-granular engine, ``shards=`` and ``chunk=``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core.dvfs import npb_phase_split, phase_split, tier_tables
from repro_torch.core.policy import (BIG, Policy, _host, apply_queue_spec,
                                     make_policy, select)
from repro_torch.core.result import CampaignResult, SimResult
from repro_torch.core.workload_model import NPB_PROFILES, npb_tables
from repro_torch.device import resolve_device
from repro_torch.kernels.kth_free.ops import check_mode, kth_free_time
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


def _fault_factors(fault_key, J: int, fvecs):
    """Deterministic straggler x failure factor of every job in every lane,
    [B, J] f32.  fault_key: [B, 2]; fvecs: [B, 4] = (straggler_prob,
    straggler_factor, failure_prob, restart_overhead)."""
    jj = torch.arange(J, device=fault_key.device)
    u = prng.uniform(prng.fold_in(fault_key[:, None, :], jj), (2,))
    fv = fvecs[:, None, :]
    slow = torch.where(u[..., 0] < fv[..., 0], fv[..., 1], 1.0)
    fail = torch.where(u[..., 1] < fv[..., 2], 1.0 + fv[..., 3], 1.0)
    return slow * fail


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
    ``avail``'s last dimension is the system axis."""
    for wi in range(outage.shape[1]):
        o0, o1 = outage[:, wi, 0], outage[:, wi, 1]
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


def _alloc_(node_free, sel, kth_sel, need, finish):
    """In place: every lane takes, on its system ``sel``, the nodes
    strictly below its kth free time plus first-by-index ties at it, until
    ``finish``.  node_free [B, S, N]; sel/kth_sel/need/finish [B]."""
    B, _, N = node_free.shape
    idx = sel.view(B, 1, 1).expand(B, 1, N)
    row = node_free.gather(1, idx).squeeze(1)                    # [B, N]
    kth = kth_sel.unsqueeze(-1)
    below = row < kth
    tie = row == kth
    tie_rank = tie.cumsum(-1) - 1
    room = (need - below.sum(-1)).unsqueeze(-1)
    take = below | (tie & (tie_rank < room))
    node_free.scatter_(1, idx, torch.where(take, finish.unsqueeze(-1),
                                           row).unsqueeze(1))


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


def _power_totals(arrs, makespan, busy):
    """The SCC power fields of every result.  The arrival-indexed scan
    tracks no cluster power trace: ``peak_power`` is NaN and
    ``capped_delay`` zero."""
    return {"peak_power": torch.full_like(makespan, math.nan),
            "capped_delay": torch.zeros_like(makespan),
            "idle_energy": _idle_energy(arrs, makespan, busy)}


def _tier_rows(tt, p: int, C_row, T_row, runs_row, avail_row, C_pred_row,
               T_pred_row):
    """Expand one job's [B, S] selection rows over the (tier x system)
    candidate axis, tier-major (flat index f * S + s, tier 0 first)."""
    rc, rt = tt["rc"][p], tt["rt"][p]                            # [F, S]
    F, S = rc.shape
    flat = lambda x: x.reshape(x.shape[:-2] + (F * S,))
    tile = lambda x: flat(x.unsqueeze(-2).expand(x.shape[:-1] + (F, S)))
    return (flat(C_row.unsqueeze(-2) * rc), flat(T_row.unsqueeze(-2) * rt),
            tile(runs_row), tile(avail_row),
            flat(C_pred_row.unsqueeze(-2) * rc),
            flat(T_pred_row.unsqueeze(-2) * rt))


def _arrival_run(arrs: dict, w: Workload, policy: Policy, lanes: dict, *,
                 warm_start: bool, placer, totals_only: bool) -> dict:
    """Step every lane through the job stream (one job per step) and
    return the result fields with a leading [B] dimension."""
    dev = arrs["free0"].device
    T_true, C_true, E_true = arrs["T_true"], arrs["C_true"], arrs["E_true"]
    P, S = T_true.shape
    N = arrs["free0"].shape[-1]
    prog_h = np.asarray(w.prog)
    arrival_h = np.asarray(w.arrival, np.float32)
    J = len(prog_h)
    B = lanes["k"].shape[0]
    outage = arrs.get("outage")
    tiered = policy.tiered
    tt = tier_tables(arrs, policy.freq_tiers) if tiered else None
    FS = len(policy.freq_tiers) * S

    # per-program tables gathered at the chosen candidate: base (C, T) for
    # the learned tables, realized (T, E) for the job (tier-major when
    # tiered, matching the selector's flat candidate index)
    truth = torch.stack([C_true, T_true], -1)                    # [P, S, 2]
    act = (torch.stack([tt["T"], tt["E"]], -1).reshape(P, FS, 2) if tiered
           else torch.stack([T_true, E_true], -1))               # [P, FS, 2]
    nreq_b = arrs["n_req"].unsqueeze(1).expand(P, B, S).contiguous()

    sel_key, fault_key = prng.split(prng.key(lanes["seed"])).unbind(1)
    factor = _fault_factors(fault_key, J, lanes["fvec"])         # [B, J]
    draws = None
    if policy.objective == "random":
        jj = torch.arange(J, device=dev)
        draws = prng.randint(prng.fold_in(sel_key[:, None, :], jj), (), 0,
                             FS)                                 # [B, J]
    kjob = torch.as_tensor(np.asarray(w.k_job, np.float32), device=dev)
    K = torch.where(torch.isnan(kjob), lanes["k"][:, None], kjob)  # [B, J]
    pol = replace(policy, ucb_scale=lanes["ucb_scale"],
                  freq_weight=lanes["freq_weight"])

    node_free = arrs["free0"].expand(B, S, N).clone()
    if warm_start:
        CT = truth.expand(B, P, S, 2).clone()
        runs = torch.ones((B, P, S), dtype=torch.int32, device=dev)
    else:
        CT = torch.zeros((B, P, S, 2), dtype=F32, device=dev)
        runs = torch.zeros((B, P, S), dtype=torch.int32, device=dev)
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
            # Kahan-compensated f32 sums (the reference's totals_only path)
            add = torch.stack([E_act, wait, (wait + T_act) / T_act], 1)
            y = add - comps
            t = sums + y
            comps = (t - sums) - y
            sums = t
            fin_max = torch.maximum(fin_max, finish)
            wait_max = torch.maximum(wait_max, wait)
        else:
            sel_out[:, j] = sel_x
            start_out[:, j] = start

    tabs = {"C_tab": CT[..., 0], "T_tab": CT[..., 1], "runs": runs,
            "n_backfilled": torch.zeros(B, dtype=torch.int32, device=dev)}
    if totals_only:
        return {"total_energy": sums[:, 0], "makespan": fin_max,
                "total_wait": sums[:, 1], "slowdown_sum": sums[:, 2],
                "max_wait": wait_max, "busy": busy,
                **_power_totals(arrs, fin_max, busy), **tabs}

    # per-job fields, recomputed from the placements with the step's own
    # elementwise ops (so the bits equal the step's)
    prog = torch.as_tensor(prog_h.astype(np.int64), device=dev)
    sel = sel_out % S if tiered else sel_out
    ac = act[prog.expand(B, J), sel_out]                         # [B, J, 2]
    T_act, E_act = (ac * factor.unsqueeze(-1)).unbind(-1)
    start = start_out
    finish = fma(ac[..., 0], factor, start)
    wait = start - torch.as_tensor(arrival_h, device=dev)
    nodes = arrs["n_req"][prog.expand(B, J), sel]
    makespan = finish.amax(-1)
    return {
        "system": sel.to(torch.int32), "start": start, "finish": finish,
        "wait": wait, "energy": E_act, "runtime": T_act, "nodes": nodes,
        "tier": (sel_out // S).to(torch.int32),
        "backfilled": torch.zeros((B, J), dtype=torch.bool, device=dev),
        "total_energy": E_act.sum(-1), "makespan": makespan,
        "total_wait": wait.sum(-1), "max_wait": wait.amax(-1),
        "slowdown_sum": ((wait + T_act) / T_act).sum(-1), "busy": busy,
        **_power_totals(arrs, makespan, busy), **tabs,
    }


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
    queue:      queue-discipline spec overriding the policy's ("fcfs")
    device:     None = CUDA (``RuntimeError`` if absent), or any torch
                device such as "cpu"

    Not in this slice (``NotImplementedError``): EASY / conservative
    queues, a finite ``power_cap``, ``engine="events"``, ``shards=`` and
    ``chunk=``.

    ``run(w)`` returns a ``SimResult`` when no axis is present, else a
    ``CampaignResult`` with ``axes`` ordered (fault, policy, seed).
    ``totals_only=True`` keeps the per-job accounting in running sums
    (Kahan-compensated) instead of [*grid, J] outputs.
    """

    def __init__(self, policy: str | Policy = "paper", *,
                 placer: str | None = None, faults=None, seeds=0,
                 warm_start: bool = False, queue: str | None = None,
                 power_cap=None, engine: str | None = None, shards=None,
                 chunk=None, device=None):
        self.policy = make_policy(policy) if isinstance(policy, str) else policy
        if queue is not None:
            self.policy = apply_queue_spec(self.policy, queue)
        if power_cap is not None:
            self.policy = replace(self.policy,
                                  power_cap=np.asarray(power_cap, np.float32))
        if engine not in (None, "arrival", "events"):
            raise ValueError(f"engine {engine!r} not in (None, 'arrival', "
                             "'events')")
        if self.policy.queue == "easy_backfill":
            raise NotImplementedError(
                "queue='easy_backfill' is not ported yet (ROADMAP Queue 1 "
                "item 4, batched EASY)")
        if self.policy.queue == "conservative":
            raise NotImplementedError(
                "queue='conservative' is not ported yet (ROADMAP Queue 1 "
                "item 6, conservative core)")
        if self.policy.capped:
            raise NotImplementedError(
                "a finite power_cap needs the event-granular core, not "
                "ported yet (ROADMAP Queue 1 item 5)")
        if engine == "events":
            raise NotImplementedError(
                "engine='events' is not ported yet (ROADMAP Queue 1 item 5, "
                "event core)")
        if shards is not None:
            raise NotImplementedError(
                "shards= is not ported yet (ROADMAP Queue 1 item 7, "
                "campaign scale)")
        if chunk is not None:
            raise NotImplementedError(
                "chunk= is not ported yet (ROADMAP Queue 1 item 7, "
                "campaign scale)")
        check_mode(placer)
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
                 "freq_weight": lane(fw),
                 "seed": seeds[None, None, :].expand(F, G, R).reshape(B),
                 "fvec": fmat[:, None, None, :].expand(F, G, R, 4)
                 .reshape(B, 4)}
        lanes = {n: x.to(dev) for n, x in lanes.items()}
        out = _arrival_run(_workload_arrays(w, dev), w, pol, lanes,
                           warm_start=self.warm_start, placer=self.placer,
                           totals_only=totals_only)

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
