"""The legacy simulator surface on the port's engine.

The reference's historical entry points, thin shims over ``Scheduler``:

  - ``simulate_jax(w, scfg)``      == ``Scheduler(policy).run(w)``
  - ``sweep_k(w, scfg, ks)``       == ``Scheduler(policy-with-K-grid).run(w)``
  - ``run_campaign(w, scfg, ...)`` == ``Scheduler(policy, faults, seeds).run(w)``

each returning the result's ``to_dict()`` (per-job tensors, totals and
the derived metrics).  The names are the reference's, so a caller changes
only the package name; each shim also takes ``device=`` (None = CUDA,
``RuntimeError`` without one; "cpu" runs on the CPU).

``simulate_py`` is the plain float64 numpy mirror for differential
testing, the reference's line for line.  It dispatches through the same
policy registry as the engine (``policy.select_py``) and shares none of
the engine's code, so it is an oracle that runs beside the card: the
engine's placements on any device are held against it.  Its one change
from the reference is the ``random`` objective's draw, which replays
the engine's threefry stream through ``utils.prng``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dvfs import tier_tables_py
from repro_torch.core.engine import (  # noqa: F401 (re-exports)
    FaultConfig, Scheduler, SimConfig, Workload, make_npb_workload,
)
from repro_torch.core.policy import (  # noqa: F401 (re-exports)
    BIG, UNCAPPED, _host, _paper_rule_py, make_policy, select_py,
)
from repro_torch.utils import prng


def simulate_jax(w: Workload, scfg: SimConfig, *, device=None):
    """One simulation: ``Scheduler(scfg.policy(), ...).run(w).to_dict()``."""
    return _scheduler_for(scfg, device=device).run(w).to_dict()


def sweep_k(w: Workload, scfg: SimConfig, ks, *, device=None):
    """The whole simulation over a K grid in one run (Figs 1-4 are one
    call): a K-grid ``Policy``.  Per-job overrides in ``w.k_job`` win over
    the swept K at their positions."""
    pol = scfg.policy().with_params(k=np.asarray(list(ks), np.float32))
    return _scheduler_for(scfg, policy=pol, device=device).run(w).to_dict()


def run_campaign(w: Workload, scfg: SimConfig, ks=None, seeds=None,
                 faults=None, *, device=None):
    """The (fault-config x K x seed) grid in one run.

    ks:     iterable of K values            (default: [scfg.k])
    seeds:  iterable of PRNG seeds          (default: [scfg.seed])
    faults: iterable of FaultConfig         (default: scfg's fault fields)

    Returns ``simulate_jax``'s dict with leading axes [K, R], or [F, K, R]
    with a fault grid, on every entry.  Per-job K overrides in
    ``w.k_job`` win over the swept K at their positions."""
    ks = [scfg.k] if ks is None else list(ks)
    pol = scfg.policy().with_params(k=np.asarray(ks, np.float32))
    seeds = [scfg.seed] if seeds is None else list(seeds)
    sched = _scheduler_for(scfg, policy=pol, seeds=seeds,
                           faults=None if faults is None else tuple(faults),
                           device=device)
    return sched.run(w).to_dict()


def _scheduler_for(scfg: SimConfig, policy=None, seeds=None, faults=None,
                   device=None):
    """SimConfig -> Scheduler with the legacy axis conventions: the built
    policy carries scfg's queue / window / power_cap overrides, and the
    core override rides separately."""
    return Scheduler(
        scfg.policy() if policy is None else policy,
        placer=scfg.placer, warm_start=scfg.warm_start,
        engine=scfg.core or None,
        seeds=scfg.seed if seeds is None else seeds,
        faults=FaultConfig(
            straggler_prob=scfg.straggler_prob,
            straggler_factor=scfg.straggler_factor,
            failure_prob=scfg.failure_prob,
            restart_overhead=scfg.restart_overhead,
        ) if faults is None else faults,
        device=device)


# ------------------------------------------------------------ python mirror

class _PySim:
    """Mutable float64 simulation state shared by the mirror's queue
    disciplines: per-node free-time lists, learned tables, and the
    placement primitives that must stay in lockstep with the engine
    (``_earliest`` / ``_alloc`` / the table update in ``_scan_sim``)."""

    def __init__(self, w: Workload, scfg: SimConfig, pol):
        self.w, self.scfg, self.pol = w, scfg, pol
        P, S = w.T_true.shape
        self.S = S
        # [S, maxN] float64 free-time table, BIG-padded past each system's
        # real node count.  Pads sort last and never win an allocation, so
        # they stay exactly BIG for the whole run; ``counts``/``mask``
        # bound the real slots.  The array form keeps every hot path
        # (sort / stable argsort / masked sums) vectorized, which is what
        # lets differential streams reach >=10k jobs.
        self.counts = np.asarray(w.n_nodes, np.int64)
        self.mask = (np.arange(int(self.counts.max()))[None, :]
                     < self.counts[:, None])
        self.node_free = np.where(self.mask, 0.0, BIG)
        if scfg.warm_start:
            self.C_tab, self.T_tab = w.C_true.copy(), w.T_true.copy()
            self.runs = np.ones((P, S), np.int64)
        else:
            self.C_tab = np.zeros((P, S))
            self.T_tab = np.zeros((P, S))
            self.runs = np.zeros((P, S), np.int64)
        self.sel_key = (prng.split(prng.key(scfg.seed))[0]
                        if pol.objective == "random" else None)
        # DVFS tier axis (float64 twin of the engine's tier_tables; None
        # for untier policies so the historical path is untouched)
        self.tiers = tuple(pol.freq_tiers)
        self.F = len(self.tiers)
        self.tt = tier_tables_py(w, self.tiers) if pol.tiered else None

    # tier-aware ground-truth lookups (base values when untier)
    def T_of(self, p, f, s):
        return float(self.tt["T"][p, f, s] if self.tt is not None
                     else self.w.T_true[p, s])

    def E_of(self, p, f, s):
        return float(self.tt["E"][p, f, s] if self.tt is not None
                     else self.w.E_true[p, s])

    def w_of(self, p, f, s):
        if self.tt is not None:
            return float(self.tt["w"][p, f, s])
        return float(self.w_pow[p, s])

    def avail_for(self, p: int, arr: float, node_free=None) -> np.ndarray:
        """Earliest start per system (float64 kth-free + outage push),
        vectorized over systems: sort the free table, gather the kth free
        time per system, then push through maintenance windows in order."""
        w = self.w
        nf = self.node_free if node_free is None else node_free
        need = np.asarray(w.n_req[p], np.int64)                      # [S]
        kidx = np.maximum(np.minimum(need, self.counts) - 1, 0)
        kth = np.sort(nf, axis=1)[np.arange(self.S), kidx]
        avail = np.where(need <= self.counts, np.maximum(arr, kth), BIG)
        if w.outage is not None:
            og = np.asarray(w.outage, np.float64)
            for wi in range(og.shape[1]):            # in-order window push
                o0, o1 = og[:, wi, 0], og[:, wi, 1]
                avail = np.where((o0 <= avail) & (avail < o1), o1, avail)
        return avail

    def choose(self, j: int, node_free=None, arr=None, avail=None):
        """Policy selection for job j under current state: returns
        (p, arr, avail, sel, f) — ``f`` the chosen frequency tier (0 for
        untier policies).  ``node_free`` selects an alternate table,
        ``avail`` overrides the availability row entirely (the
        conservative mirror's hole-aware earliest fit: [S], or [F, S]
        per-tier under DVFS), ``arr`` overrides the arrival floor."""
        w, S, F = self.w, self.S, self.F
        p = int(w.prog[j])
        arr = float(w.arrival[j]) if arr is None else float(arr)
        kj = float(w.k_job[j])
        k = self.scfg.k if np.isnan(kj) else kj
        if avail is None:
            avail = self.avail_for(p, arr, node_free)
        if self.tt is None:
            rand_sel = None
            if self.pol.objective == "random":
                rand_sel = int(prng.randint(
                    prng.fold_in(self.sel_key, j), (), 0, S))
            sel = select_py(
                self.pol, c_row=self.C_tab[p], t_row=self.T_tab[p],
                runs_row=self.runs[p], avail_row=avail, k=k,
                c_pred_row=w.C_pred[p], t_pred_row=w.T_pred[p],
                rand_sel=rand_sel)
            return p, arr, avail, sel, 0
        # tier-major expansion, the float64 twin of engine._tier_rows
        rc, rt = self.tt["rc"][p], self.tt["rt"][p]              # [F, S]
        av = np.asarray(avail, np.float64)
        avail_x = (av.reshape(-1) if av.ndim == 2
                   else np.broadcast_to(av, (F, S)).reshape(-1))
        rand_sel = None
        if self.pol.objective == "random":
            rand_sel = int(prng.randint(
                prng.fold_in(self.sel_key, j), (), 0, F * S))
        sel_x = select_py(
            self.pol,
            c_row=(self.C_tab[p][None, :] * rc).reshape(-1),
            t_row=(self.T_tab[p][None, :] * rt).reshape(-1),
            runs_row=np.broadcast_to(self.runs[p], (F, S)).reshape(-1),
            avail_row=avail_x, k=k,
            c_pred_row=(np.asarray(w.C_pred[p], np.float64)[None, :]
                        * rc).reshape(-1),
            t_pred_row=(np.asarray(w.T_pred[p], np.float64)[None, :]
                        * rt).reshape(-1),
            rand_sel=rand_sel)
        return p, arr, avail, sel_x % S, sel_x // S

    @staticmethod
    def alloc(node_free, sel: int, need: int, finish: float):
        """Allocate the ``need`` earliest-free nodes (stable argsort ==
        the engine's first-by-index tie-break; BIG pads sort last, so only
        real slots are ever written)."""
        idx = np.argsort(node_free[sel], kind="stable")[:need]
        node_free[sel, idx] = finish

    def place(self, j: int):
        """Place job j (the FCFS step body): allocate, update tables,
        return the per-job record."""
        w = self.w
        p, arr, avail, sel, f = self.choose(j)
        T_act = self.T_of(p, f, sel)
        E_act = self.E_of(p, f, sel)
        # learned tables absorb BASE (tier-0) observations
        T_upd = float(w.T_true[p, sel])
        C_act = float(w.C_true[p, sel])
        start = float(avail[sel])
        finish = start + T_act
        self.alloc(self.node_free, sel, int(w.n_req[p, sel]), finish)
        n = self.runs[p, sel]
        self.C_tab[p, sel] = (self.C_tab[p, sel] * n + C_act) / (n + 1)
        self.T_tab[p, sel] = (self.T_tab[p, sel] * n + T_upd) / (n + 1)
        self.runs[p, sel] += 1
        return (sel, start, finish, start - arr, E_act, T_act, f)

    # ------------------------------------------- event-replay helpers
    # The power / event / placement bookkeeping shared verbatim by the
    # two event-granular mirrors (``_events_py`` / ``_cons_py``).  Both
    # replays mutate this state through the same methods, so the
    # float64 op order is identical on the shared path by construction
    # (the differential suite pins both sides against the engine).

    def init_event_state(self, pol):
        """Power model + event-clock accumulators of an event replay."""
        w, S = self.w, self.S
        J = len(w.prog)
        self.ev_cap = float(np.asarray(pol.power_cap).reshape(-1)[0])
        self.ev_capped = self.ev_cap < UNCAPPED
        self.idle_pw = (np.zeros(S) if w.idle_w is None
                        else np.asarray(w.idle_w, np.float64))
        self.w_pow = np.asarray(w.E_true, np.float64) / np.maximum(
            np.asarray(w.T_true, np.float64), 1e-30)
        self.node_pow = np.zeros_like(self.node_free)
        self.ev_out = [None] * J
        self.backfilled = np.zeros(J, bool)
        self.a, self.now = 0, float(w.arrival[0])
        self.nbf = 0
        self.peak = float(sum(self.idle_pw[s] * int(w.n_nodes[s])
                              for s in range(S)))
        self.cdel = 0.0
        self.pblock: dict[int, float] = {}
        self.placed_n = 0

    def power_at(self, t: float) -> float:
        """Cluster draw at ``t``: per-node allocated watts while busy,
        idle watts otherwise (pads contribute 0 via the slot mask)."""
        draw = np.where(self.node_free > t, self.node_pow,
                        self.idle_pw[:, None])
        return float(np.sum(draw, where=self.mask))

    def next_event(self, extra=()) -> bool:
        """Advance ``now`` to the next event: the earliest node-free
        time, the next arrival, any ``extra`` times (the conservative
        replay's reservation starts), or an outage end.  Returns whether
        the clock moved.  Pad slots sit at exactly BIG and are excluded —
        they are capacity that never existed, not completions."""
        w = self.w
        nf = self.node_free
        cand = nf[(nf > self.now) & (nf < BIG)]
        nxt = [float(cand.min())] if cand.size else []
        if self.a < len(w.prog) and float(w.arrival[self.a]) > self.now:
            nxt.append(float(w.arrival[self.a]))
        nxt.extend(t for t in extra if t > self.now)
        if w.outage is not None:
            nxt.extend(float(t1) for _, t1 in w.outage.reshape(-1, 2)
                       if t1 > self.now)
        if nxt:
            self.now = min(nxt)
            return True
        return False

    def record_block(self, j: int):
        """First time job j is the next would-be placement but
        power-blocked (feeds ``capped_delay``)."""
        self.pblock[j] = min(self.pblock.get(j, np.inf), self.now)

    def outage_gated(self, sel: int, start_q: float) -> bool:
        """Capped starts quantize to ``now``: the start gate must hold
        there (mirrors the engine's res_ok outage clause)."""
        return self.ev_capped and self.w.outage is not None and any(
            o0 <= start_q < o1 for o0, o1 in self.w.outage[sel])

    def realize(self, j: int, chosen: int, p: int, sel: int, start: float,
                T_act: float, E_act: float, wjob: float, arr: float,
                p_now: float, tier: int = 0):
        """Realize a placement: allocate + per-node power, update the
        learned tables, and record the power / backfill / per-job
        outputs — the float64 twin of the engine's placement tail.
        ``T_act``/``E_act`` are the (possibly tier-scaled) realized
        values; the learned tables always absorb the BASE observation
        (``w.T_true[p, sel]`` — identical for untier policies)."""
        w = self.w
        finish = start + T_act
        need = int(w.n_req[p, sel])
        idx = np.argsort(self.node_free[sel], kind="stable")[:need]
        self.node_free[sel, idx] = finish
        self.node_pow[sel, idx] = wjob / max(need, 1)
        n = self.runs[p, sel]
        C_act = float(w.C_true[p, sel])
        T_upd = float(w.T_true[p, sel])
        self.C_tab[p, sel] = (self.C_tab[p, sel] * n + C_act) / (n + 1)
        self.T_tab[p, sel] = (self.T_tab[p, sel] * n + T_upd) / (n + 1)
        self.runs[p, sel] += 1
        new_P = p_now - need * self.idle_pw[sel] + wjob
        self.peak = max(self.peak, new_P)
        if j in self.pblock:
            self.cdel += self.now - self.pblock.pop(j)
        if chosen > 0:
            self.backfilled[j] = True
            self.nbf += 1
        self.ev_out[j] = (sel, start, finish, start - arr, E_act, T_act,
                          tier)
        self.placed_n += 1

    def event_results(self):
        return (self.ev_out, self.backfilled, self.nbf, self.peak,
                self.cdel, self.idle_pw)


def _easy_order_py(sim: _PySim, J: int, window: int):
    """Replay the engine's EASY-backfill step decisions (one placement per
    step, bounded pending window, no-delay reservation guard); yields
    (job, backfilled) in placement order."""
    w = sim.w
    pend: list[int] = []
    for t in range(J + window):
        now = float(w.arrival[t]) if t < J else np.inf
        if t < J:
            pend.append(t)
        if not pend:
            continue
        h = pend[0]
        p_h, arr_h, avail_h, sel_h, _ = sim.choose(h)
        r_h = float(avail_h[sel_h])
        chosen = None
        if len(pend) == window + 1 or r_h <= now:   # overflow: FCFS fallback
            chosen = 0
        else:
            for ci in range(1, len(pend)):
                b = pend[ci]
                p_b, _, avail_b, sel_b, f_b = sim.choose(b)
                s_b = float(avail_b[sel_b])
                trial = sim.node_free.copy()
                sim.alloc(trial, sel_b, int(w.n_req[p_b, sel_b]),
                          s_b + sim.T_of(p_b, f_b, sel_b))
                if sim.avail_for(p_h, arr_h, trial)[sel_h] <= r_h:
                    chosen = ci
                    break
        if chosen is not None:
            yield pend.pop(chosen), chosen > 0


def _events_py(sim: _PySim, pol):
    """Float64 replay of the event-granular core (``make_event_step``
    under ``_sim_pieces``, fcfs / easy_backfill): merged
    arrival/completion event clock, bounded
    pending buffer with stalled admission, per-discipline eligibility,
    and power-cap deferral with the same start rule (capped runs start at
    the current event).  Returns the per-job records plus the power
    accumulators."""
    w = sim.w
    J = len(w.prog)
    Wc = int(pol.window) + 1
    queue = pol.queue
    sim.init_event_state(pol)
    capped = sim.ev_capped
    pend: list[int] = []
    max_iters = 16 * J + 64           # far above the engine's step bound

    for _ in range(max_iters):
        if sim.placed_n == J:
            break
        now = sim.now
        pushed = False
        if sim.a < J and float(w.arrival[sim.a]) <= now and len(pend) < Wc:
            pend.append(sim.a)
            sim.a += 1
            pushed = True

        chosen = None
        evals = [sim.choose(j) for j in pend]    # (p, arr, avail, sel, f)
        starts_res = [float(ev[2][ev[3]]) for ev in evals]
        p_now = sim.power_at(now)

        def trial_of(ci):
            p_b, _, avail_b, sel_b, f_b = evals[ci]
            s_b = max(starts_res[ci], now) if capped else starts_res[ci]
            trial = sim.node_free.copy()
            sim.alloc(trial, sel_b, int(w.n_req[p_b, sel_b]),
                      s_b + sim.T_of(p_b, f_b, sel_b))
            return trial

        def guard_ok(ci):
            if ci == 0:
                return True
            if queue == "fcfs":
                return False
            trial = trial_of(ci)        # EASY: only the head is guarded
            p_h, arr_h, _, sel_h, _ = evals[0]
            return sim.avail_for(p_h, arr_h, trial)[sel_h] <= starts_res[0]

        blocked_recorded = False
        for ci in range(len(pend)):
            if starts_res[ci] > now or not guard_ok(ci):
                continue
            p_b, _, _, sel_b, f_b = evals[ci]
            if sim.outage_gated(sel_b, max(starts_res[ci], now)):
                continue
            new_P = (p_now
                     - int(w.n_req[p_b, sel_b]) * sim.idle_pw[sel_b]
                     + sim.w_of(p_b, f_b, sel_b))
            if capped and new_P > sim.ev_cap:
                if not blocked_recorded:
                    # the next would-be placement is power-blocked
                    sim.record_block(pend[ci])
                    blocked_recorded = True
                continue
            chosen = ci
            break

        if chosen is None and not pushed:
            if sim.next_event():
                continue
            if not pend:
                break
            chosen = 0                  # cap below the idle floor

        if chosen is None:
            continue

        # ---- place pend[chosen] (float64 twin of the engine's step)
        j = pend.pop(chosen)
        p, arr, avail, sel, f = evals[chosen]
        start = (max(starts_res[chosen], now) if capped
                 else starts_res[chosen])
        sim.realize(j, chosen, p, sel, start, sim.T_of(p, f, sel),
                    sim.E_of(p, f, sel), sim.w_of(p, f, sel), arr,
                    p_now, tier=f)
    assert sim.placed_n == J, \
        f"event mirror stalled: {sim.placed_n}/{J} placed"
    return sim.event_results()


def _cons_py(sim: _PySim, pol, check_reservations: bool = False):
    """Float64 replay of the conservative core (``make_cons_step`` under
    ``_sim_pieces``):
    hole-aware reservations assigned at admission (earliest capacity fit
    around every pending reservation interval), placements realizing
    reservations as their starts arrive, power-cap deferral in
    reservation order.

    ``check_reservations=True`` additionally asserts the conservative
    invariant at every placement: the real table can honor the
    reservation (earliest realizable start <= reserved start) — i.e. no
    backfill ever delayed a pending reservation (uncapped runs only;
    a binding cap legitimately breaks promises downstream)."""
    w, S = sim.w, sim.S
    J = len(w.prog)
    Wc = int(pol.window) + 1
    sim.init_event_state(pol)
    capped = sim.ev_capped
    pend: list[dict] = []
    max_iters = 16 * J + 64

    def earliest_fit(p, t0, Trow=None):
        """Float64 twin of the engine's hole-aware earliest fit,
        vectorized over the candidate set: per system, the first
        candidate start whose capacity (free nodes minus reservation
        occupancy) covers the job's whole window — i.e. capacity holds at
        the start AND at every reservation start that dips inside it.
        ``Trow`` overrides the per-system durations (the DVFS mirror's
        per-tier evaluation)."""
        out = np.full(S, BIG)
        r_sel = np.asarray([r["sel"] for r in pend], np.int64)
        r_start = np.asarray([r["start"] for r in pend], np.float64)
        r_fin = np.asarray([r["fin"] for r in pend], np.float64)
        r_need = np.asarray([r["need"] for r in pend], np.float64)
        fin_c = np.maximum(r_fin, t0)       # candidates shared across S
        for s in range(S):
            n = int(w.n_req[p, s])
            Td = float(w.T_true[p, s] if Trow is None else Trow[s])
            free = sim.node_free[s, :int(sim.counts[s])]
            mine = r_sel == s
            rs, rf, rn = r_start[mine], r_fin[mine], r_need[mine]

            def availn(ts):
                """Free-node count minus this system's reservation
                occupancy at each time in ``ts``."""
                cnt = (free[None, :] <= ts[:, None]).sum(1)
                occ = (((rs[None, :] <= ts[:, None])
                        & (ts[:, None] < rf[None, :])) * rn).sum(1)
                return cnt - occ

            cands = np.concatenate(([t0], np.maximum(free, t0), fin_c))
            if w.outage is not None:
                og = np.asarray(w.outage, np.float64)
                for wi in range(og.shape[1]):    # in-order window push
                    o0, o1 = og[s, wi]
                    cands = np.where((o0 <= cands) & (cands < o1),
                                     o1, cands)
            cands = np.unique(cands)             # == sorted(set(...))
            ok = availn(cands) >= n
            if rs.size:
                dip = availn(rs) < n             # capacity at res starts
                ok &= ~(((cands[:, None] < rs[None, :])
                         & (rs[None, :] < cands[:, None] + Td))
                        & dip[None, :]).any(1)
            hit = np.flatnonzero(ok)
            if hit.size:
                out[s] = cands[hit[0]]
        return out

    def reserve(j, t0):
        """Admission: hole-aware earliest fit + selection — the new
        reservation row (reservations are NOT committed to node_free).
        Under DVFS each tier gets its own earliest fit (a slower tier's
        longer window may land in a different hole)."""
        pp = int(w.prog[j])
        if sim.tt is not None:
            avail = np.stack([
                earliest_fit(pp, t0, np.asarray(sim.tt["T"][pp, fi],
                                                np.float64))
                for fi in range(sim.F)])                         # [F, S]
            p, _, _, sel, f = sim.choose(j, arr=t0, avail=avail)
            start = float(avail[f, sel])
        else:
            avail = earliest_fit(pp, t0)
            p, _, _, sel, f = sim.choose(j, arr=t0, avail=avail)
            start = float(avail[sel])
        T_act = sim.T_of(p, f, sel)
        return dict(j=j, p=p, t0=t0, sel=sel, start=start, T=T_act,
                    fin=start + T_act, E=sim.E_of(p, f, sel),
                    need=int(w.n_req[p, sel]),
                    wjob=sim.w_of(p, f, sel), tier=f)

    for _ in range(max_iters):
        if sim.placed_n == J:
            break
        now = sim.now
        pushed = False
        if sim.a < J and float(w.arrival[sim.a]) <= now and len(pend) < Wc:
            pend.append(reserve(sim.a, float(w.arrival[sim.a])))
            sim.a += 1
            pushed = True

        # realizability + power, in slot (admission) order
        p_now = sim.power_at(now)
        chosen = None
        blocked_recorded = False
        elig_res = []
        for ci, rec in enumerate(pend):
            avail_real = sim.avail_for(rec["p"], rec["t0"])[rec["sel"]]
            ok = rec["start"] <= now and avail_real <= now
            if ok:
                # the engine's cap-deferred start gate: now must not sit
                # inside the reserved system's maintenance window
                ok = not sim.outage_gated(rec["sel"],
                                          max(rec["start"], now))
            elig_res.append(ok)
            if not ok:
                continue
            new_P = (p_now - rec["need"] * sim.idle_pw[rec["sel"]]
                     + rec["wjob"])
            if capped and new_P > sim.ev_cap:
                if not blocked_recorded:
                    sim.record_block(rec["j"])
                    blocked_recorded = True
                continue
            chosen = ci
            break

        if chosen is None and not pushed:
            if sim.next_event(extra=(r["start"] for r in pend)):
                continue
            if not any(elig_res):
                break                      # drained
            chosen = elig_res.index(True)   # cap below the idle floor

        if chosen is None:
            continue

        rec = pend.pop(chosen)
        j, p, sel = rec["j"], rec["p"], rec["sel"]
        start = max(rec["start"], now) if capped else rec["start"]
        if check_reservations and not capped:
            avail_real = sim.avail_for(p, rec["t0"])[sel]
            assert avail_real <= rec["start"] + 1e-6, (
                f"reservation of job {j} not realizable: {avail_real} > "
                f"{rec['start']} (a backfill delayed it)")
        sim.realize(j, chosen, p, sel, start, rec["T"], rec["E"],
                    rec["wjob"], float(w.arrival[j]), p_now,
                    tier=rec["tier"])
    assert sim.placed_n == J, \
        f"conservative mirror stalled: {sim.placed_n}/{J}"
    return sim.event_results()


def simulate_py(w: Workload, scfg: SimConfig, *,
                check_reservations: bool = False):
    """Reference implementation for differential tests (no faults path).

    Dispatches through the policy registry (``scfg.mode`` may name ANY
    registered policy) and mirrors every queue discipline — FCFS arrival
    order, EASY backfilling (arrival-indexed reservation semantics
    replayed step for step), and the event-granular core (conservative
    backfilling, power caps, or an explicit ``core="events"`` override),
    replayed event for event.  All arithmetic runs in float64 numpy — an
    independent-precision check of the f32 engine — except the "random"
    draw, which replays the engine's threefry stream (``utils.prng``) so
    the two implementations place identically.  ``w``'s fields may be
    tensors on any device; the mirror reads them as host numpy arrays.
    """
    assert scfg.straggler_prob == 0 and scfg.failure_prob == 0, \
        "python mirror covers the deterministic path"
    w = dataclasses.replace(w, **{
        f.name: _host(getattr(w, f.name)) for f in dataclasses.fields(w)
        if getattr(w, f.name) is not None
        and not isinstance(getattr(w, f.name), tuple)})
    pol = scfg.policy()
    sim = _PySim(w, scfg, pol)
    J = len(w.prog)
    use_events = scfg.core == "events" or pol.capped
    if pol.queue == "conservative":
        out, backfilled, nbf, peak, cdel, idle_w = _cons_py(
            sim, pol, check_reservations=check_reservations)
    elif use_events:
        out, backfilled, nbf, peak, cdel, idle_w = _events_py(sim, pol)
    else:
        if pol.queue == "easy_backfill":
            order = _easy_order_py(sim, J, int(pol.window))
        else:
            order = ((j, False) for j in range(J))
        out = [None] * J
        backfilled = np.zeros(J, bool)
        for j, bf in order:
            out[j] = sim.place(j)
            backfilled[j] = bf
        nbf, peak, cdel = int(backfilled.sum()), np.nan, 0.0
        idle_w = (np.zeros(sim.S) if w.idle_w is None
                  else np.asarray(w.idle_w, np.float64))
    assert all(rec is not None for rec in out), "job left unplaced"

    sel, start, finish, wait, E, T_act, tier = map(np.array, zip(*out))
    makespan = finish.max()
    busy = np.zeros(sim.S)
    np.add.at(busy, sel, T_act * np.asarray(w.n_req)[np.asarray(w.prog), sel])
    idle_energy = (float(np.sum(idle_w * np.asarray(w.n_nodes))) * makespan
                   - float(np.sum(idle_w * busy)))
    return {
        "system": sel, "start": start, "finish": finish, "wait": wait,
        "energy": E, "runtime": T_act, "backfilled": backfilled,
        "tier": tier, "n_backfilled": int(nbf),
        "total_energy": E.sum(), "makespan": makespan,
        "total_wait": wait.sum(), "max_wait": wait.max(),
        "peak_power": peak, "capped_delay": cdel,
        "idle_energy": idle_energy,
    }
