"""Plain numpy campaigns: FCFS and EASY backfilling over the multi-system
centre, the paper's selection rule, warm-started tables and the
contiguous fault model, for a set of independent lanes.

A lane is one (K, seed) point of an operator's campaign with its fault
model.  Each job asks every system when ``n_req`` of its nodes are next
free (the n-th smallest entry of the system's node-free row), the paper's
rule picks the least energy coefficient C among the systems whose runtime
T is within a fraction K of the fastest (ties on T, then on index), and
the job takes the earliest-free nodes until ``start + T x factor``.  The
learned (C, T) tables take running means of truth x factor.  Totals are
Kahan-compensated running sums in job order.

Arithmetic is float32 with one rounding per operation, except the sites
the engine's specification computes as one fused multiply-add: FCFS's
finish time and both table sums ``old x n + truth x factor``, EASY's table
sums (its finish is an add), and the idle-energy dot products.
``prec="bf16"`` rounds every value and result to bfloat16 instead: the
control that a comparison must fail.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import prng
from portbench.reference.model import BIG

F32 = np.float32


def _bf16(x):
    """Round float32 values to the nearest bfloat16, ties to even."""
    b = np.asarray(x, F32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(F32)


def _f32(x):
    return np.asarray(x, F32)


def rounding(prec: str):
    """The rounding applied to every float result: float32, or bfloat16
    (the control)."""
    if prec == "f32":
        return _f32
    if prec == "bf16":
        return _bf16
    raise ValueError(f"unknown precision {prec!r}")


def fma32(a, b, c):
    """``a * b + c`` rounded once to float32: the product of two float32
    values is exact in float64, and the float64 sum is rounded to odd
    before its rounding to float32, so that rounding is the correct one."""
    a, b, c = (np.asarray(x, F32).astype(np.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((e != 0) & even, np.nextafter(s, np.where(e > 0, np.inf,
                                                             -np.inf)), s)
    return s.astype(F32)


def fault_factors(seeds, fvec, J: int, r=_f32):
    """[L, J] factor of the contiguous fault model: the straggler factor
    when a job straggles, times 1 + restart overhead when it fails; the
    straggler and failure bits are the job's two uniform draws from the
    lane's fault key (the second key split from ``key(seed)``)."""
    fault_key = prng.split(prng.key(seeds))[:, 1, :]                # [L, 2]
    u = prng.uniform(prng.fold_in(fault_key[:, None, :],
                                  np.arange(J)[None, :]), 2)           # [L, J, 2]
    fv = r(fvec)[:, None, :]
    slow = np.where(u[..., 0] < fv[..., 0], fv[..., 1], F32(1.0))
    fail = u[..., 1] < fv[..., 2]
    return r(slow * np.where(fail, r(F32(1.0) + fv[..., 3]), F32(1.0)))


def _paper_rule(c, t, runs, avail, onepk, r):
    """The paper's selector over the last (system) axis: an unexplored
    system first (the earliest available), else the least C among the
    systems with T <= T_min (1 + K), ties on T then on index."""
    known = runs > 0
    c = np.where(known, c, BIG)
    t = np.where(known, t, BIG)
    feas = t <= r(t.min(-1, keepdims=True) * onepk)
    feas = feas | ~feas.any(-1, keepdims=True)
    cbest = np.where(feas, c, BIG).min(-1, keepdims=True)
    exploit = np.argmin(np.where(feas & (c == cbest), t, BIG), -1)
    explore = np.argmin(np.where(~known, avail, BIG), -1)
    return np.where((~known).any(-1), explore, exploit)


def _alloc_rows(rows, kth, need, finish):
    """Node-free rows [..., N] after an allocation: every node strictly
    below the kth free time, then first-by-index nodes at it, until
    ``need`` nodes hold ``finish``."""
    below = rows < kth[..., None]
    tie = rows == kth[..., None]
    rank = np.cumsum(tie, -1, dtype=np.int16) - 1
    room = need - below.sum(-1)
    take = below | (tie & (rank < room[..., None]))
    return np.where(take, finish[..., None], rows)


def _kth_sorted(srt, n):
    """The n-th smallest entry of each sorted row (n clipped to [1, N])."""
    idx = np.clip(n, 1, srt.shape[-1]) - 1
    return np.take_along_axis(srt, idx[..., None], -1)[..., 0]


def _kahan(sums, comps, add, r):
    y = r(add - comps)
    t = r(sums + y)
    return t, r(r(t - sums) - y)


def _dot(a, b, r):
    acc = np.zeros(b.shape[:-1], F32)
    for s in range(b.shape[-1]):
        acc = r(fma32(a[s], b[..., s], acc))
    return acc


def _start(tab, lanes, prec):
    r = rounding(prec)
    L = len(lanes["k"])
    J = len(tab["prog"])
    st = dict(r=r, L=L, J=J, ar=np.arange(L),
              T=r(tab["T"]), C=r(tab["C"]), E=r(tab["E"]),
              arrival=r(tab["arrival"]), n_req=tab["n_req"],
              onepk=r(F32(1.0) + r(lanes["k"]))[:, None],
              factor=fault_factors(lanes["seed"], lanes["fvec"], J, r))
    P, S = st["T"].shape
    st["free"] = np.broadcast_to(r(tab["free0"]),
                                 (L,) + tab["free0"].shape).copy()
    # warm start: the tables hold the truth, every pair has run once
    st["CT"] = np.broadcast_to(np.stack([st["C"], st["T"]], -1),
                               (L, P, S, 2)).copy()
    st["runs"] = np.ones((L, P, S), np.int64)
    st["busy"] = np.zeros((L, S), F32)
    st["sums"] = np.zeros((L, 3), F32)
    st["comps"] = np.zeros((L, 3), F32)
    st["fin_max"] = np.zeros(L, F32)
    st["wait_max"] = np.zeros(L, F32)
    return st


def _totals(st, tab, n_backfilled) -> dict:
    r = st["r"]
    n_exist = (tab["free0"] < BIG).sum(1).astype(F32)
    idle = r(tab["idle_w"])
    idle_e = r(fma32(_dot(idle, n_exist, r), st["fin_max"],
                     -_dot(idle, st["busy"], r)))
    return {"total_energy": st["sums"][:, 0], "total_wait": st["sums"][:, 1],
            "slowdown_sum": st["sums"][:, 2], "makespan": st["fin_max"],
            "max_wait": st["wait_max"], "busy": st["busy"],
            "idle_energy": idle_e, "C_tab": st["CT"][..., 0],
            "T_tab": st["CT"][..., 1], "runs": st["runs"],
            "n_backfilled": n_backfilled}


def run_fcfs(tab: dict, lanes: dict, prec: str = "f32") -> dict:
    """FCFS: jobs placed in arrival order, one a step.  ``tab``: the
    stream's tables (``model``); ``lanes``: ``k`` [L], ``seed`` [L],
    ``fvec`` [L, 4] (straggler prob, straggler factor, failure prob,
    restart overhead).  Returns the campaign totals, one row a lane."""
    st = _start(tab, lanes, prec)
    r, ar, J = st["r"], st["ar"], st["J"]
    T, C, E, free, CT, runs = (st[k] for k in ("T", "C", "E", "free", "CT",
                                               "runs"))
    S = T.shape[1]
    for j in range(J):
        p, arr = tab["prog"][j], st["arrival"][j]
        need_row = st["n_req"][p]                                  # [S]
        srt = np.sort(free, -1)
        kth = _kth_sorted(srt, np.broadcast_to(need_row, (st["L"], S)))
        avail = np.maximum(kth, arr)
        sel = _paper_rule(CT[:, p, :, 0], CT[:, p, :, 1], runs[:, p], avail,
                          st["onepk"], r)
        fac = st["factor"][:, j]
        start = avail[ar, sel]
        n = runs[ar, p, sel].astype(F32)
        t_true, c_true, e_true = T[p, sel], C[p, sel], E[p, sel]
        finish = r(fma32(t_true, fac, start))
        new_c = r(fma32(CT[ar, p, sel, 0], n, r(c_true * fac)))
        new_t = r(fma32(CT[ar, p, sel, 1], n, r(t_true * fac)))
        need = need_row[sel]
        free[ar, sel] = _alloc_rows(free[ar, sel], kth[ar, sel], need, finish)
        n1 = r(n + F32(1.0))
        CT[ar, p, sel, 0] = r(new_c / n1)
        CT[ar, p, sel, 1] = r(new_t / n1)
        runs[ar, p, sel] += 1
        t_act, e_act = r(t_true * fac), r(e_true * fac)
        st["busy"][ar, sel] = r(st["busy"][ar, sel]
                                + r(t_act * need.astype(F32)))
        wait = r(start - arr)
        add = np.stack([e_act, wait, r(r(wait + t_act) / t_act)], 1)
        st["sums"], st["comps"] = _kahan(st["sums"], st["comps"], add, r)
        st["fin_max"] = np.maximum(st["fin_max"], finish)
        st["wait_max"] = np.maximum(st["wait_max"], wait)
    return _totals(st, tab, np.zeros(st["L"], np.int64))


def run_easy(tab: dict, lanes: dict, window: int, prec: str = "f32") -> dict:
    """EASY backfilling over a pending window of ``window`` jobs: J +
    window steps, each pushing the next arrival (the last ``window``
    steps push none, at ``now`` = BIG) and placing at most one job.  The
    head goes when the window is full or its reserved start (the
    earliest start on the system the rule picks for it) has come; else
    the first pending job, in arrival order, whose trial allocation (at
    its own earliest start on its own pick) leaves the head's earliest
    start on the head's system no later than the reservation; else none.
    Every pending job is scored against the same node-free table."""
    st = _start(tab, lanes, prec)
    r, ar, J, L = st["r"], st["ar"], st["J"], st["L"]
    T, C, E, free, CT, runs = (st[k] for k in ("T", "C", "E", "free", "CT",
                                               "runs"))
    arrival, n_req = st["arrival"], st["n_req"]
    Wc = window + 1
    slot = np.arange(Wc)
    pend = np.full((L, Wc), J, np.int64)
    nbf = np.zeros(L, np.int64)
    a2 = ar[:, None]
    for t in range(J + window):
        if t < J:
            size0 = (pend < J).sum(1)
            pend[ar, np.minimum(size0, Wc - 1)] = t
            forced = size0 == window
            now = arrival[t]
        else:
            forced = np.zeros(L, bool)
            now = BIG
        head_valid = pend[:, 0] < J
        jjs = np.minimum(pend, J - 1)                              # [L, Wc]
        ps = tab["prog"][jjs]
        nreq_rows = n_req[ps]                                      # [L, Wc, S]
        srt = np.sort(free, -1)                                    # [L, S, N]
        kths = _kth_sorted(srt[:, None, :, :], nreq_rows)          # [L, Wc, S]
        avails = np.maximum(kths, arrival[jjs][..., None])
        sels = _paper_rule(CT[a2, ps, :, 0], CT[a2, ps, :, 1], runs[a2, ps],
                           avails, st["onepk"][:, :, None], r)     # [L, Wc]
        factors = st["factor"][a2, jjs]
        on_sel = lambda x: np.take_along_axis(x, sels[..., None], -1)[..., 0]  # noqa: E731
        starts = on_sel(avails)
        t_acts = r(T[ps, sels] * factors)
        needs = on_sel(nreq_rows)
        finishes = r(starts + t_acts)
        kth_sel = on_sel(kths)
        # the head's earliest start after each slot's trial allocation (at
        # the slot's earliest start on its pick): a trial moves it only
        # when it takes nodes of the head's system; elsewhere it is the
        # reservation itself
        sel_h, r_h = sels[:, 0], starts[:, 0]
        avail_h2 = np.broadcast_to(r_h[:, None], (L, Wc)).copy()
        li, si = np.nonzero(sels == sel_h[:, None])
        trial = _alloc_rows(free[li, sel_h[li]], kth_sel[li, si],
                            needs[li, si], finishes[li, si])
        avail_h2[li, si] = np.maximum(
            _kth_sorted(np.sort(trial, -1), needs[li, 0]),
            arrival[jjs[li, 0]])
        place_head = head_valid & (forced | (r_h <= now))
        elig = np.where(slot == 0, place_head[:, None],
                        (head_valid & ~place_head)[:, None] & (pend < J)
                        & (avail_h2 <= r_h[:, None]))
        chosen = np.where(elig, slot, Wc).min(1)
        placed = chosen < Wc
        ci = np.minimum(chosen, Wc - 1)
        jj, p, sel = jjs[ar, ci], ps[ar, ci], sels[ar, ci]
        fac, t_act, start = factors[ar, ci], t_acts[ar, ci], starts[ar, ci]
        need = needs[ar, ci]
        row = free[ar, sel]
        free[ar, sel] = np.where(placed[:, None], _alloc_rows(
            row, kth_sel[ar, ci], need, finishes[ar, ci]), row)
        old = CT[ar, p, sel]                                       # [L, 2]
        n = runs[ar, p, sel].astype(F32)
        obs = np.stack([C[p, sel], T[p, sel]], 1)
        tot = r(fma32(old, n[:, None], r(obs * fac[:, None])))
        CT[ar, p, sel] = np.where(placed[:, None],
                                  r(tot / r(n + F32(1.0))[:, None]), old)
        runs[ar, p, sel] += placed
        nbf += placed & (chosen > 0)
        shifted = np.concatenate([pend[:, 1:], np.full((L, 1), J)], 1)
        pend = np.where(slot < chosen[:, None], pend, shifted)
        e_act = r(E[p, sel] * fac)
        finish = r(start + t_act)
        wait = r(start - arrival[jj])
        add = np.stack([e_act, wait, r(r(wait + t_act) / t_act)], 1)
        st["sums"], st["comps"] = _kahan(st["sums"], st["comps"],
                                         np.where(placed[:, None], add,
                                                  F32(0.0)), r)
        st["fin_max"] = np.maximum(st["fin_max"],
                                   np.where(placed, finish, F32(0.0)))
        st["busy"][ar, sel] = r(st["busy"][ar, sel] + np.where(
            placed, r(t_act * need.astype(F32)), F32(0.0)))
        st["wait_max"] = np.maximum(st["wait_max"],
                                    np.where(placed, wait, F32(0.0)))
    return _totals(st, tab, nbf)
