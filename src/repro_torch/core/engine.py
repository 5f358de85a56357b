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
branchless.  Fault factors, ``random``-objective picks and the effective
K are drawn per job before the steps that read them (``_job_draws``;
threefry is counter based, one ``fold_in(key, j)`` per job, so the draws
of any set of jobs are the bits of the reference's per-step draws).
Per-job outputs go to preallocated ``[B, J]`` tensors.
``queue="easy_backfill"`` runs the windowed EASY core (``_easy_run``):
J + W steps, at most one placement each, with the same per-job placement
arithmetic.  Conservative queues, finite power caps and
``engine="events"`` run on the event-granular cores (``core/events.py``),
as in the reference.

Every core runs its steps in chunks (``_chunks``): the monolithic run is
one chunk with the draws of all J jobs, indexed by job id; ``chunk=n``
runs windows of n steps, each with the draws of only the jobs its steps
can read (``_window_ids``: each lane's pending jobs, its next n arrivals
and the sentinel's stand-in), found by ``_lookup``.  The steps are the
same, so chunked results are bit-identical; with ``totals_only`` no
tensor beside the lanes has a J-sized dimension.  ``shards=`` splits the
lanes over devices (``_lane_split``).

``easy_eval="unrolled"`` runs the reference's per-slot EASY loop, the
batched step's bit-identity reference (``_easy_run``).

Spans (``utils/trace``; off by default, one flag check each): ``run``
(``Scheduler.run``) holds ``run.workload_arrays`` (the host-to-device
copies), ``run.setup`` and ``run.job_draws`` (inside ``_setup`` and
``_job_draws``, so the event cores and the service get them too), one
``run.steps`` a chunk, and ``run.results``.  Under ``run.steps`` every
step of the arrival-indexed cores is a ``step`` span: FCFS's phases
``fcfs.earliest`` / ``fcfs.select`` / ``fcfs.commit``, EASY's
``easy.push`` / ``easy.score`` / ``easy.trial`` / ``easy.recheck`` /
``easy.commit`` (the unrolled step's own per-slot loop has no phase
spans, only the push and commit it shares).
"""

from __future__ import annotations

import math
import warnings
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
from repro_torch.utils import prng, trace
from repro_torch.utils.fp import fma
from repro_torch.utils.tree import flatten_with_names, map_with_names

F32 = torch.float32


@dataclass(frozen=True)
class SimConfig:
    """Legacy single-run configuration (mode string + fault fields) of the
    ``simulate_jax`` / ``sweep_k`` / ``run_campaign`` shims
    (``core/simulator.py``); ``Scheduler`` supersedes it for new code.
    ``mode`` accepts any registered policy name."""
    mode: str = "paper"
    k: float = 0.0                 # allowed runtime-increase fraction
    straggler_prob: float = 0.0
    straggler_factor: float = 2.0
    failure_prob: float = 0.0
    restart_overhead: float = 0.5
    seed: int = 0
    # True => profile tables pre-filled with ground truth (the paper's
    # Figs 1-4 regime)
    warm_start: bool = False
    # kth-free dispatch: None = auto, or "cuda" / "torch" / "sort"
    placer: str | None = None
    # queue-discipline overrides; "" / 0 defer to the registered policy's
    # own metadata
    queue: str = ""
    queue_window: int = 0
    # SCC power cap (Watts); inf = uncapped (a finite cap runs on the
    # event-granular core)
    power_cap: float = float("inf")
    # scan granularity override: "" = auto, or "arrival" / "events"
    core: str = ""

    def policy(self) -> Policy:
        pol = make_policy(self.mode, k=self.k)
        over = {}
        if self.queue:
            over["queue"] = self.queue
        if self.queue_window:
            over["window"] = self.queue_window
        if self.power_cap != float("inf"):
            over["power_cap"] = float(self.power_cap)
        return replace(pol, **over) if over else pol


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


def _fault_draws(fault_key, jobs, fvecs):
    """Deterministic straggler factor f32 and failure flag bool of jobs
    ``jobs`` ([J] ids, shared by the lanes, or [B, M] per lane) in every
    lane: [B, J] or [B, M].  fault_key: [B, 2]; fvecs: [B, 4] =
    (straggler_prob, straggler_factor, failure_prob, restart_overhead)."""
    u = prng.uniform(prng.fold_in(fault_key[:, None, :], jobs), (2,))
    fv = fvecs[:, None, :]
    slow = torch.where(u[..., 0] < fv[..., 0], fv[..., 1], 1.0)
    return slow, u[..., 1] < fv[..., 2]


def _fault_factors(slow, fail, fvecs):
    """The contiguous fault model's factor per job, [B, J]: a failing job
    re-does ``restart_overhead`` of its work in one placement."""
    return slow * torch.where(fail, 1.0 + fvecs[:, 3:], 1.0)


def _job_draws(st: dict, jobs=None) -> dict:
    """Every per-job quantity a step reads besides the workload's own
    arrays, for jobs ``jobs`` (None: all J, indexed by job id; or [B, M]
    ids per lane, a chunk's ``_window_ids``): the straggler factor
    ``slow``, failure flag ``fail`` and contiguous fault ``factor``, the
    ``random`` objective's candidate ``draws`` (None for other
    objectives) and the effective ``K`` (the job's own k, else the
    lane's).  Threefry is counter based, so a job's draws are the same
    bits whichever set it is drawn in."""
    with trace.span("run.job_draws"):
        jj = torch.arange(st["J"], device=st["dev"]) if jobs is None else jobs
        slow, fail = _fault_draws(st["fault_key"], jj, st["fvec"])
        draws = None
        if st["objective"] == "random":
            draws = prng.randint(prng.fold_in(st["sel_key"][:, None, :], jj),
                                 (), 0, st["FS"])
        kjob = st["kjob"] if jobs is None else _per_lane(st["kjob"], jobs)
        return dict(slow=slow, fail=fail,
                    factor=_fault_factors(slow, fail, st["fvec"]),
                    draws=draws,
                    K=torch.where(torch.isnan(kjob), st["k"][:, None], kjob))


def _per_lane(stream, idx):
    """A job stream read at job ids ``idx``: ``stream`` [J], the one
    stream every lane reads (a batch run; ``idx`` of any shape), or
    [B, J], one stream a lane (a session pool; ``idx`` [B, k]).  The
    batch run keeps its stream one-dimensional: a [1, J] copy would be
    a job-sized tensor of two dimensions, which a chunked run must not
    make (``tests/test_torch_chunked_memory.py``)."""
    return stream[idx] if stream.dim() == 1 else stream.gather(1, idx)


def _chunks(length: int, chunk):
    """(first step, step count) of each chunk of a ``length``-step run:
    one chunk when ``chunk`` is None."""
    if chunk is None:
        return [(0, length)]
    return [(lo, min(chunk, length - lo)) for lo in range(0, length, chunk)]


def _window_ids(pending, nxt, J: int):
    """The sorted ids of every job a lane can read in a chunk, [B, Wc + n +
    1]: its pending jobs ``pending`` [B, Wc] (the sentinel J among them),
    the next arrivals ``nxt`` ([B, n] or [1, n]: a chunk of n steps pushes
    at most n jobs), and J - 1, which sentinel slots evaluate; every id
    clamped to J - 1.  Re-queued jobs were pending or pushed, so a lane
    never reads a job outside its ids, however far its pending jobs lie
    apart."""
    B = pending.shape[0]
    ids = torch.cat([pending, nxt.expand(B, -1),
                     pending.new_full((B, 1), J - 1)], 1).clamp_max(J - 1)
    return ids.sort(1).values


def _lookup(ids, jobs):
    """The column of each job of ``jobs`` [B, k] in its lane's sorted
    ``ids`` [B, M].  A job that is not there gets column M, so the gather
    that reads with it raises: a read outside the window fails loudly."""
    loc = torch.searchsorted(ids, jobs)
    return torch.where(ids.gather(1, loc) == jobs, loc, ids.shape[1])


def _draw_cols(st: dict, jobs):
    """Where the draws of ``jobs`` [B, k] (ids below J) lie in the current
    ``_job_draws`` tables: their ids when the tables hold every job, else
    their columns in the chunk's ``ids``."""
    ids = st.get("ids")
    return jobs if ids is None else _lookup(ids, jobs)


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


def _earliest(node_free, nreq, arr, placer, outage):
    """(kth free time, earliest start) per lane and system for one job:
    the kth-free radix select, floored at the arrival (a float, or a
    [B, 1] tensor of each lane's) and pushed out of any open maintenance
    window."""
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
    tables gathered at a chosen candidate, the keys and per-lane values
    ``_job_draws`` draws from, the per-lane policy, and the initial
    node-free and learned tables."""
    with trace.span("run.setup"):
        dev = arrs["free0"].device
        T_true, C_true, E_true = arrs["T_true"], arrs["C_true"], arrs["E_true"]
        P, S = T_true.shape
        N = arrs["free0"].shape[-1]
        J = np.shape(w.prog)[-1]
        B = lanes["k"].shape[0]
        tiered = policy.tiered
        tt = tier_tables(arrs, policy.freq_tiers) if tiered else None
        FS = len(policy.freq_tiers) * S
        sel_key, fault_key = prng.split(prng.key(lanes["seed"])).unbind(1)
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
            sel_key=sel_key, fault_key=fault_key, fvec=lanes["fvec"],
            k=lanes["k"], objective=policy.objective,
            # [J], or [B, J] in a session pool (``_per_lane``)
            kjob=torch.as_tensor(np.asarray(w.k_job, np.float32), device=dev),
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
    with trace.span("run.results"):
        return {"total_energy": sums[:, 0], "makespan": fin_max,
                "total_wait": sums[:, 1], "slowdown_sum": sums[:, 2],
                "max_wait": wait_max, "busy": busy,
                **_power_totals(arrs, fin_max, busy), **tabs}


def _arrival_run(arrs: dict, w: Workload, policy: Policy, lanes: dict, *,
                 warm_start: bool, placer, totals_only: bool,
                 chunk=None) -> dict:
    """Step every lane through the job stream (one job per step) and
    return the result fields with a leading [B] dimension.  A chunk of
    steps [lo, lo + n) reads the draws of jobs [lo, lo + n) alone."""
    st = _setup(arrs, w, policy, lanes, warm_start)
    dev, S, J, B = st["dev"], st["S"], st["J"], st["B"]
    tiered, tt, truth, act = st["tiered"], st["tt"], st["truth"], st["act"]
    pol = st["pol"]
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

    for lo, n_steps in _chunks(J, chunk):
        d = _job_draws(st, None if chunk is None else
                       torch.arange(lo, lo + n_steps, device=dev))
        factor, draws, K = d["factor"], d["draws"], d["K"]      # [B, n]
        with trace.span("run.steps"):
            for j in range(lo, lo + n_steps):
                with trace.span("step", j=j):
                    with trace.span("fcfs.earliest"):
                        c = j - lo
                        p, arr = int(prog_h[j]), float(arrival_h[j])
                        nreq = nreq_b[p]  # [B, S]
                        kth, avail = _earliest(node_free, nreq, arr, placer, outage)
                    with trace.span("fcfs.select"):
                        ct = CT[:, p]  # [B, S, 2]
                        rows = (ct[..., 0], ct[..., 1], runs[:, p], avail,
                                arrs["C_pred"][p], arrs["T_pred"][p])
                        if tiered:
                            rows = _tier_rows(tt, p, *rows)
                        c_r, t_r, r_r, a_r, cp_r, tp_r = rows
                        sel_x = select(pol, c_row=c_r, t_row=t_r, runs_row=r_r,
                                       avail_row=a_r, k=K[:, c], c_pred_row=cp_r,
                                       t_pred_row=tp_r,
                                       draw=None if draws is None else draws[:, c])
                        sel = sel_x % S if tiered else sel_x
                        sel1 = sel.unsqueeze(1)  # [B, 1]
                    with trace.span("fcfs.commit"):
                        fac = factor[:, c]
                        ac = act[p][sel_x]  # [B, 2]
                        start = avail.gather(1, sel1).squeeze(1)
                        idx2 = sel1.unsqueeze(-1).expand(B, 1, 2)
                        old = ct.gather(1, idx2).squeeze(1)  # [B, 2]
                        n = runs[:, p].gather(1, sel1).to(F32)  # [B, 1]
                        upd = truth[p][sel] * fac.unsqueeze(1)  # C_act, T_upd
                        # one fused multiply-add each, as the reference
                        # computes them: finish = T * factor + start,
                        # table = old * n + obs
                        fused = fma(torch.cat([old, ac[:, :1]], 1),
                                    torch.cat([n, n, fac.unsqueeze(1)], 1),
                                    torch.cat([upd, start.unsqueeze(1)], 1))
                        finish = fused[:, 2]
                        need = nreq.gather(1, sel1).squeeze(1)
                        _alloc_(node_free, sel, kth.gather(1, sel1).squeeze(1), need,
                                finish)
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

    factor = factor if chunk is None else _job_draws(st)["factor"]
    return _job_results(arrs, st, w, sel_out, start_out, tabs, factor,
                        busy=busy, fused_finish=True)


def _job_results(arrs, st, w, sel_out, start, tabs, factor, *, busy=None,
                 fused_finish: bool, backfilled=None) -> dict:
    """The full path's result fields from each job's candidate index
    ``sel_out``, start and fault ``factor`` [B, J], recomputed with the
    step's own elementwise ops (so the bits equal the step's).
    ``finish`` is one fused multiply-add where the core's step fuses it
    (FCFS, unrolled EASY) and a plain add where it does not (batched
    EASY).  ``busy=None`` accumulates the busy node-seconds here, in job
    order as the reference's scatter-add."""
    with trace.span("run.results"):
        dev, S, J, B = st["dev"], st["S"], st["J"], st["B"]
        prog = torch.as_tensor(np.asarray(w.prog).astype(np.int64),
                               device=dev).expand(B, J)
        sel = sel_out % S if st["tiered"] else sel_out
        ac = st["act"][prog, sel_out]  # [B, J, 2]
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
              warm_start: bool, placer, totals_only: bool, chunk=None,
              easy_eval: str = "batched") -> dict:
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
    Per-job outputs are scattered to arrival order as they are placed.
    A chunk of steps reads its draws at ``_window_ids``: a head can wait
    behind any number of backfilled jobs, so the pending jobs are not a
    range of the stream.

    ``easy_eval="unrolled"`` runs the reference's bit-identity reference
    for the batched step instead (``unrolled_step``): slot by slot, a
    selection, a trial allocation and the head's recheck, 2 W + 2
    kth-free calls a step.  It predates the tier axis, so a tiered policy
    raises ``ValueError``, as in the reference."""
    if policy.tiered and easy_eval != "batched":
        raise ValueError("freq_tiers requires easy_eval='batched' (the "
                         "unrolled loop predates the tier axis and exists "
                         "only as the single-tier bit-identity reference)")
    unrolled = easy_eval == "unrolled"
    st = _setup(arrs, w, policy, lanes, warm_start)
    dev, P, S, N, J, B = (st[k] for k in ("dev", "P", "S", "N", "J", "B"))
    tiered, tt, truth, act = st["tiered"], st["tt"], st["truth"], st["act"]
    pol = st["pol"]
    node_free, CT, runs = st["node_free"], st["CT"], st["runs"]
    W = int(policy.window)
    Wc = W + 1
    outage = arrs.get("outage")
    n_req, T_true = arrs["n_req"], arrs["T_true"]
    C_pred, T_pred = arrs["C_pred"], arrs["T_pred"]
    arrival_h = np.asarray(w.arrival, np.float32)
    prog = torch.as_tensor(np.asarray(w.prog).astype(np.int64), device=dev)
    arrival = torch.as_tensor(arrival_h, device=dev)
    # the head recheck's kth-free mode (and the unrolled step's): every
    # mode is bit-exact, so absent a placer the kernel on the card and one
    # sort on the CPU
    recheck = placer or ("cuda" if node_free.is_cuda else "sort")
    fuse_obs = (tiered or B == 1) and not unrolled

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

    def sel_for(j, draws, K):
        """The policy's system and the earliest start of job ids ``j``
        [B] (the sentinel J evaluates job J - 1; one kth-free call in the
        recheck's mode): (job, program, kth free [B, S], earliest start
        [B, S], system [B])."""
        jj = j.clamp_max(J - 1)
        p = prog[jj]
        kth, avail = _earliest(node_free, n_req[p], arrival[jj].unsqueeze(1),
                               recheck, outage)
        jd = _draw_cols(st, jj.unsqueeze(1))
        ct = CT.gather(1, p.view(B, 1, 1, 1).expand(B, 1, S, 2)).squeeze(1)
        sel = select(
            pol, c_row=ct[..., 0], t_row=ct[..., 1],
            runs_row=runs.gather(1, p.view(B, 1, 1).expand(B, 1, S))
            .squeeze(1), avail_row=avail, k=K.gather(1, jd).squeeze(1),
            c_pred_row=C_pred[p], t_pred_row=T_pred[p],
            draw=None if draws is None else draws.gather(1, jd).squeeze(1))
        return jj, p, kth, avail, sel

    def unrolled_step(pend, head_valid, forced, now, factor, draws, K):
        """The reference's unrolled candidate loop: the head's selection,
        then slot by slot a selection, a trial allocation on a copy of the
        node-free table and the recheck of the head's earliest start on
        it, then the chosen job's selection again: 2 W + 2 kth-free calls
        a step, every slot evaluated in every lane (masked)."""
        at = lambda x, i: x.gather(1, i.unsqueeze(1)).squeeze(1)  # noqa: E731
        hj, p_h, _, avail_h, sel_h = sel_for(pend[:, 0], draws, K)
        r_h = at(avail_h, sel_h)
        place_head = head_valid & (forced | (r_h <= now))
        chosen = torch.where(place_head, 0, Wc)
        may_backfill = head_valid & ~place_head
        for ci in range(1, Wc):
            b = pend[:, ci]
            live = may_backfill & (b < J) & (chosen == Wc)
            bj, p_b, kth_b, avail_b, sel_b = sel_for(b, draws, K)
            fin_b = fma(T_true[p_b, sel_b], at(
                factor, _draw_cols(st, bj.unsqueeze(1)).squeeze(1)),
                at(avail_b, sel_b))
            trial = node_free.clone()
            _alloc_(trial, sel_b, at(kth_b, sel_b), n_req[p_b, sel_b], fin_b)
            _, avail_h2 = _earliest(trial, n_req[p_h],
                                    arrival[hj].unsqueeze(1), recheck, outage)
            chosen = torch.where(live & (at(avail_h2, sel_h) <= r_h), ci,
                                 chosen)
        placed = chosen < Wc
        j_pl = torch.where(placed, at(pend, chosen.clamp_max(Wc - 1)), J)
        jj, p, kth, avail, sel = sel_for(j_pl, draws, K)
        fac = at(factor, _draw_cols(st, jj.unsqueeze(1)).squeeze(1))
        T_act = T_true[p, sel] * fac
        start = at(avail, sel)
        need = n_req[p, sel]
        row = node_free.gather(1, sel.view(B, 1, 1).expand(B, 1, N))
        new_row = _alloc_row(row.squeeze(1), at(kth, sel), need,
                             fma(T_true[p, sel], fac, start))
        return chosen, jj, p, sel, sel, fac, T_act, start, need, new_row

    def batched_step(pend, head_valid, forced, now, factor, draws, K):
        """Every slot scored against the same node-free table in one
        batched pass (two kth-free calls): the chosen slot, its job and
        placement, and its trial row of the chosen system."""
        with trace.span("easy.score"):
            jjs = pend.clamp_max(J - 1)                              # [B, Wc]
            jd = _draw_cols(st, jjs)
            ps = prog[jjs]
            nreq_rows = n_req[ps]  # [B, Wc, S]
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
                k=K.gather(1, jd), c_pred_rows=cp_r, t_pred_rows=tp_r,
                draws=None if draws is None else draws.gather(1, jd))
            sels = sels_x % S if tiered else sels_x                  # [B, Wc]
        with trace.span("easy.trial"):
            factors = factor.gather(1, jd)
            on_sel = lambda x: x.gather(-1, sels.unsqueeze(-1)).squeeze(-1)  # noqa: E731
            starts = on_sel(avails)
            T_acts = act[ps, sels_x, 0] * factors
            needs = on_sel(nreq_rows)
            # each slot's trial allocation, on its own chosen row
            trials = _alloc_row(
                node_free.gather(1, sels.unsqueeze(-1).expand(B, Wc, N)),
                on_sel(kths), needs, starts + T_acts)  # [B, Wc, N]

        with trace.span("easy.recheck"):
            # the no-delay guard for every slot at once: a trial can delay
            # the head only on the head's reserved system sel_h, so recheck
            # each trial's row of it (untouched rows give r_h back exactly)
            sel_h = sels[:, 0]
            head_row = node_free.gather(1, sel_h.view(B, 1, 1).expand(B, 1, N))
            trial_h = torch.where((sels == sel_h.unsqueeze(1)).unsqueeze(-1),
                                  trials, head_row)  # [B, Wc, N]
            kth_h2 = kth_free_time(trial_h, needs[:, :1].expand(B, Wc),
                                   force=recheck)
            avail_h2 = torch.maximum(kth_h2, arrival[jjs[:, :1]])
            if outage is not None:
                avail_h2 = _push_out_of_outage(avail_h2,
                                               outage[sel_h].unsqueeze(1))
            r_h = starts[:, 0]  # reservation
            place_head = head_valid & (forced | (r_h <= now))

            # first fit: the least eligible slot index (Wc = none)
            elig = torch.where(
                slot == 0, place_head.unsqueeze(1),
                (head_valid & ~place_head).unsqueeze(1) & (pend < J)
                & (avail_h2 <= r_h.unsqueeze(1)))
            chosen = torch.where(elig, slot, Wc).amin(1)             # [B]
            ci = chosen.clamp_max(Wc - 1).unsqueeze(1)               # [B, 1]
            pick = lambda x: x.gather(1, ci).squeeze(1)  # noqa: E731
            return (chosen, pick(jjs), pick(ps), pick(sels_x), pick(sels),
                    pick(factors), pick(T_acts), pick(starts), pick(needs),
                    trials.gather(1, ci.unsqueeze(-1).expand(B, 1, N))
                    .squeeze(1))

    for lo, n_steps in _chunks(J + W, chunk):
        if chunk is not None:
            st["ids"] = _window_ids(pend, torch.arange(
                lo, lo + n_steps, device=dev).view(1, -1), J)
        d = _job_draws(st, st.get("ids"))
        factor, draws, K = d["factor"], d["draws"], d["K"]
        with trace.span("run.steps"):
            for t in range(lo, lo + n_steps):
                with trace.span("step", t=t):
                    with trace.span("easy.push"):
                        # push the arrival into the first sentinel slot
                        # (size <= W at step start keeps it in range); a
                        # full window forces the head
                        if t < J:
                            size0 = (pend < J).sum(1, keepdim=True)  # [B, 1]
                            pend.scatter_(1, size0.clamp_max(Wc - 1), t)
                            forced = size0.squeeze(1) == W
                            now = float(arrival_h[t])
                        else:
                            forced, now = no, BIG
                        head_valid = pend[:, 0] < J

                    r = (unrolled_step if unrolled else batched_step)(
                        pend, head_valid, forced, now, factor, draws, K)
                    chosen, jj, p, sel_x, sel, fac, T_act, start, need, new_row = r
                    placed = chosen < Wc

                    with trace.span("easy.commit"):
                        # the chosen trial row IS the placement
                        row_idx = sel.view(B, 1, 1).expand(B, 1, N)
                        node_free.scatter_(1, row_idx, torch.where(
                            placed.view(B, 1, 1), new_row.unsqueeze(1),
                            node_free.gather(1, row_idx)))
                        # the learned tables absorb base observations, old *
                        # n + truth * factor, with the product the
                        # reference's compiled step fuses (read from its CPU
                        # machine code): truth * factor under DVFS tiers or
                        # with a single lane of the batched step, else old *
                        # n (the unrolled step fuses old * n at any lane
                        # count)
                        flat = (p * S + sel).unsqueeze(1)  # [B, 1]
                        flat2 = flat.unsqueeze(-1).expand(B, 1, 2)
                        old = CT_flat.gather(1, flat2).squeeze(1)  # [B, 2]
                        n = runs_flat.gather(1, flat).to(F32)  # [B, 1]
                        obs = truth[p, sel]  # C, T true
                        tot = (fma(obs, fac.unsqueeze(1), old * n) if fuse_obs
                               else fma(old, n, obs * fac.unsqueeze(1)))
                        CT_flat.scatter_(1, flat2, torch.where(
                            placed.unsqueeze(1), tot / (n + 1), old).unsqueeze(1))
                        runs_flat.scatter_add_(1, flat, placed.to(torch.int32).unsqueeze(1))
                        backfill = placed & (chosen > 0)
                        nbf += backfill.to(torch.int32)

                        # pop the chosen slot: shift the tail left (chosen ==
                        # Wc: no-op)
                        shifted = torch.cat([pend[:, 1:], sentinel], 1)
                        pend = torch.where(slot < chosen.unsqueeze(1), pend, shifted)

                        if totals_only:
                            E_act = act[p, sel_x, 1] * fac
                            finish = (fma(act[p, sel_x, 0], fac, start) if unrolled
                                      else start + T_act)
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
    factor = factor if chunk is None else _job_draws(st)["factor"]
    return _job_results(arrs, st, w, sel_out[:, :J], start_out[:, :J], tabs,
                        factor, fused_finish=unrolled,
                        backfilled=bf_out[:, :J])


def _fault_vec(cfg: FaultConfig) -> list:
    return [cfg.straggler_prob, cfg.straggler_factor, cfg.failure_prob,
            cfg.restart_overhead]


def _lane_split(run, arrs_on, lanes: dict, devices, out_device) -> dict:
    """``run(arrs, lanes)`` with the lanes split over ``devices``: B padded
    to a multiple of n = len(devices) by repeating the last lane, each
    group of B_pad / n lanes run on its device against its own copy of the
    workload arrays (``arrs_on(device)``), the results gathered onto
    ``out_device`` and the padding sliced off.  Every group sees the same
    lane count, as the reference's shard body does: the fused sites
    depend on it (``events._fusions``).  The groups run one after
    another from this thread."""
    n = len(devices)
    B = lanes["k"].shape[0]
    pad = (-B) % n
    if pad:
        lanes = {name: torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])])
                 for name, x in lanes.items()}
    g = (B + pad) // n
    outs = [run(arrs_on(dev), {name: x[i * g:(i + 1) * g].to(dev)
                               for name, x in lanes.items()})
            for i, dev in enumerate(devices)]
    return {name: torch.cat([o[name].to(out_device) for o in outs])[:B]
            for name in outs[0]}


def stack_sessions(trees):
    """Stack N one-lane session trees of one structure (carries, lane
    dicts, job streams: every leaf [1, ...]) along the lane axis into the
    pool's [N, ...] tree, which the steps advance as N lanes.  Leaves must
    agree in shape, which the capacity-padded sessions guarantee."""
    trees = list(trees)
    leaves = [dict(flatten_with_names(t)) for t in trees]
    return map_with_names(
        lambda name, _: torch.cat([f[name] for f in leaves]), trees[0])


def index_session(tree, i: int):
    """Session ``i`` of a stacked pool tree, as a one-lane tree of copies
    (the inverse of ``stack_sessions`` for one lane): the steps write the
    pool's tensors in place, so a view would change under its reader."""
    return map_with_names(lambda _, x: x[i:i + 1].clone(), tree)


#: tells "core= not passed" from an explicit ``core=None``
_CORE_UNSET = object()


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
    easy_eval:  EASY candidate evaluation on the arrival core: "batched"
                (two kth-free calls a step) or "unrolled" (the reference's
                per-slot loop, its bit-identity reference: 2 W + 2 calls a
                step; tiered policies raise ``ValueError``)
    power_cap:  SCC power cap in Watts, a scalar or a 1-D grid that
                batches with ``k`` (overrides the policy's leaf); a finite
                cap runs on the event-granular core
    engine:     None (auto: "events" for conservative queues or finite
                caps, else "arrival"), "arrival" or "events"; "arrival"
                with either is a ``ValueError``.  On the event core a
                fault grid with ``failure_prob > 0`` re-queues failures
    core:       deprecated spelling of ``engine`` (``DeprecationWarning``;
                a different ``engine`` is a ``ValueError``)
    shards:     split the flat (fault x policy x seed) lanes over the local
                devices (``launch.mesh.make_grid_devices``): "auto" = every
                one, or a count; None = one device.  Lanes never interact,
                so results equal the unsharded run's (B is padded to a
                multiple of the count and the padding sliced off; with one
                lane a group the fused sites are one lane's, as in the
                reference's shards)
    chunk:      run the steps in windows of ``chunk`` steps, each with the
                draws of only the jobs it can read: with ``totals_only`` no
                tensor beside the lanes has a J-sized dimension.  Bit-
                identical to the monolithic run; None = one window.
                Composes with ``shards``
    device:     None = CUDA (``RuntimeError`` if absent), or any torch
                device such as "cpu"

    ``run(w)`` returns a ``SimResult`` when no axis is present, else a
    ``CampaignResult`` with ``axes`` ordered (fault, policy, seed).
    ``totals_only=True`` keeps the per-job accounting in running sums
    (Kahan-compensated) instead of [*grid, J] outputs.
    """

    def __init__(self, policy: str | Policy = "paper", *,
                 placer: str | None = None, faults=None, seeds=0,
                 warm_start: bool = False, queue: str | None = None,
                 easy_eval: str = "batched", power_cap=None,
                 engine: str | None = None, core=_CORE_UNSET, shards=None,
                 chunk=None, device=None):
        if core is not _CORE_UNSET:
            warnings.warn("Scheduler(core=...) is deprecated; use "
                          "engine=...", DeprecationWarning, stacklevel=2)
            if engine is not None and core is not None and core != engine:
                raise ValueError(f"core={core!r} conflicts with "
                                 f"engine={engine!r}")
            if engine is None:
                engine = core
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
        if engine == "arrival" and self.policy.queue == "conservative":
            raise ValueError("queue='conservative' requires the event-"
                             "granular core (engine='events' or None)")
        if engine == "arrival" and self.policy.capped:
            raise ValueError("a finite power_cap requires the event-"
                             "granular core (engine='events' or None): the "
                             "arrival-indexed scan cannot defer placements")
        if shards is not None and shards != "auto":
            shards = int(shards)
            if shards < 1:
                raise ValueError(f"shards must be >= 1 or 'auto', "
                                 f"got {shards}")
        self.shards = shards
        if chunk is not None:
            chunk = int(chunk)
            if chunk < 1:
                raise ValueError(f"chunk must be a positive step count, "
                                 f"got {chunk}")
        self.chunk = chunk
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

    @property
    def core(self):
        """Deprecated read alias of ``engine``."""
        return self.engine

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
        # conservative queues and finite caps need completion events;
        # failures re-queue mid-job on the event clock
        core = self.engine or ("events" if (pol.queue == "conservative"
                                            or pol.capped) else "arrival")
        kw = dict(warm_start=self.warm_start, placer=self.placer,
                  totals_only=totals_only, chunk=self.chunk)
        if core == "events":
            # imported here: the event cores import this module
            from repro_torch.core.events import _event_run
            fault_list = (() if self.faults is None else
                          (self.faults,) if not has_fault_axis
                          else self.faults)
            core_run = _event_run
            kw["retries"] = any(f.failure_prob > 0 for f in fault_list)
        elif pol.queue == "easy_backfill":
            core_run = _easy_run
            kw["easy_eval"] = self.easy_eval
        else:
            core_run = _arrival_run
        run = lambda arrs, ln: core_run(arrs, w, pol, ln, **kw)  # noqa: E731
        with trace.span("run", core=core, queue=pol.queue, B=B,
                        J=int(len(w.prog))):
            if self.shards is None:
                with trace.span("run.workload_arrays"):
                    arrs = _workload_arrays(w, dev)
                    ln = {n: x.to(dev) for n, x in lanes.items()}
                out = run(arrs, ln)
            else:
                # imported here: the mesh module counts devices at call time
                from repro_torch.launch.mesh import make_grid_devices
                out = _lane_split(run, lambda d: _workload_arrays(w, d), lanes,
                                  make_grid_devices(self.shards, dev), dev)
            with trace.span("run.results"):
                axes, lead = [], []
                for name, present, size in (("fault", has_fault_axis, F),
                                            ("policy", has_policy_axis, G),
                                            ("seed", has_seed_axis, R)):
                    if present:
                        axes.append(name)
                        lead.append(size)
                out = {n: x.reshape(tuple(lead) + x.shape[1:])
                       for n, x in out.items()}

                meta = dict(axes=tuple(axes), n_jobs=int(len(w.prog)),
                            n_nodes=np.asarray(w.n_nodes), programs=w.programs,
                            systems=w.systems, freq_tiers=pol.freq_tiers)
                if not axes:
                    return SimResult(**out, **meta)
                coords = {}
                if has_fault_axis:
                    coords["fault"] = self.faults
                if has_policy_axis:
                    coords["policy"] = replace(pol, k=k, ucb_scale=u,
                                               power_cap=pc, freq_weight=fw)
                if has_seed_axis:
                    coords["seed"] = self.seeds
                return CampaignResult(**out, **meta, coords=coords)
