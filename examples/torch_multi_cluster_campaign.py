"""End-to-end campaign on the PyTorch port: the paper's scheduler
placing and EXECUTING real jobs.  The port of
``examples/multi_cluster_campaign.py``.

A stream of NPB-analogue jobs arrives at a simulated SCC with the four JSCC
systems.  The EcoSched meta-scheduler places each job per the paper's
algorithm (learning (C, T) profiles as jobs complete: cold start, real
exploration); each placement then actually EXECUTES the reduced-scale
workload on the device (``run_benchmark``: the EP, IS and stencil kernels
on the card), with wall time scaled onto the simulated clock, so the
profile store is fed by measured runtimes, as SUPPZ feeds the algorithm
in the paper.

Compares against fastest-first and first-free baselines; injects one
degraded system mid-campaign to show history-driven routing-around
(fault tolerance).

After the executed campaign, the same scheduler is extrapolated to a
10,000-job scenario stream with the ``Scheduler`` facade: the whole
K x seed grid is one leaf-batched Policy simulated in one run, returning
a structured ``CampaignResult`` with named axes and derived metrics; then
a power-capped variant (conservative backfilling under a cap grid).

    PYTHONPATH=src python examples/torch_multi_cluster_campaign.py --jobs 15
    PYTHONPATH=src python examples/torch_multi_cluster_campaign.py \\
        --device cpu --jobs 4 --sim-jobs 500
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import JSCC_SYSTEMS, Scheduler, make_policy
from repro_torch.core.algorithm import select_system
from repro_torch.core.profiles import ProfileStore
from repro_torch.core.workload_model import (NPB_NODES, NPB_PROFILES,
                                             predict_energy)
from repro_torch.data.scenarios import make_stream_workload, sample_programs
from repro_torch.device import resolve_device
from repro_torch.utils import prng
from repro_torch.workloads import run_benchmark


def place(mode, store, p, avail, k, device):
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,  # noqa: E731
                                    device=device)
    c_row, t_row = f32(store.C[p]), f32(store.T[p])
    return int(select_system(
        mode, c_row=c_row, t_row=t_row,
        runs_row=torch.as_tensor(store.runs[p], dtype=torch.int32,
                                 device=device),
        avail_row=f32(avail), k=f32(k), c_pred_row=c_row, t_pred_row=t_row,
        key=prng.key(p, device)))


def campaign(mode, jobs, k=0.10, degrade_after=None, seed=0, device=None):
    systems = list(JSCC_SYSTEMS)
    names = [s.name for s in systems]
    progs = sorted(set(jobs))
    pidx = {n: i for i, n in enumerate(progs)}
    store = ProfileStore(len(progs), len(systems))
    free = np.zeros(len(systems))
    clock = 0.0
    total_e = 0.0
    slowdown = np.ones(len(systems))
    log = []
    for j, prog in enumerate(jobs):
        if degrade_after is not None and j == degrade_after:
            slowdown[names.index("Skylake")] = 3.0      # degraded system
        p = pidx[prog]
        avail = np.maximum(free, clock)
        s = place(mode, store, p, avail, k, device)

        # EXECUTE the real (reduced) workload; wall time feeds the profile
        t0 = time.perf_counter()
        res, ok, flops = run_benchmark(prog, scale="smoke", device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        assert ok, (prog, "verification failed")

        # map measured wall time onto the simulated system's clock
        prof = NPB_PROFILES[prog]
        n = NPB_NODES[prog][names[s]]
        e_model, w_avg, t_model = predict_energy(prof, systems[s], n)
        t_run = t_model * slowdown[s] * (0.9 + 0.2 * (wall % 1.0))
        e_run = w_avg * t_run
        c_run = e_run / (prof.flops / 1e6)

        start = avail[s]
        free[s] = start + t_run
        total_e += e_run
        store.update(p, s, c_run, t_run)
        log.append((prog, names[s], t_run, e_run))
    makespan = free.max()
    return total_e, makespan, log


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=28)
    ap.add_argument("--sim-jobs", type=int, default=10_000,
                    help="length of the simulated extrapolation stream")
    ap.add_argument("--k", type=float, default=0.10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    jobs = list(sample_programs(args.jobs, seed=0))
    print(f"campaign: {args.jobs} jobs, K={args.k:.0%}, degraded Skylake "
          f"after job {args.jobs // 2}\n")

    results = {}
    for mode in ("paper", "fastest", "first_free"):
        e, m, log = campaign(mode, jobs, k=args.k,
                             degrade_after=args.jobs // 2, device=dev)
        results[mode] = (e, m)
        placem = ",".join(f"{p}->{s[:3]}" for p, s, _, _ in log[:8])
        print(f"{mode:12s} energy={e/1e3:8.1f}kJ makespan={m:7.1f}s "
              f"[{placem}...]")

    e_p, m_p = results["paper"]
    e_f, m_f = results["fastest"]
    print(f"\nEcoSched vs fastest-first: "
          f"{100*(e_p-e_f)/e_f:+.1f}% energy, {100*(m_p-m_f)/m_f:+.1f}% makespan")

    # -------- campaign-scale extrapolation: one (K x seed) grid run ------
    n_sim = args.sim_jobs
    print(f"\nextrapolating to {n_sim} simulated jobs "
          f"(bursty arrivals, mixed size classes) ...")
    w = make_stream_workload(JSCC_SYSTEMS, n_sim, arrival="bursty",
                             rate=0.25, seed=0, pred_noise=0.05)
    ks = np.array([0.0, 0.05, 0.10, 0.20], np.float32)
    t0 = time.perf_counter()
    res = Scheduler(make_policy("paper", k=ks), seeds=range(3),
                    device=dev).run(w, totals_only=True)   # no [K, R, J]
    E = res.total_energy.cpu().numpy()                      # [K, R]
    slow = res.mean_slowdown.cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"grid {len(ks)}K x 3 seeds x {n_sim} jobs in {dt:.1f}s "
          f"(one run, axes={res.axes})")
    for i, k in enumerate(ks):
        print(f"  K={k:.0%}: energy={E[i].mean()/1e6:.2f} MJ "
              f"({100*(E[i].mean()-E[0].mean())/E[0].mean():+.1f}% vs K=0), "
              f"mean slowdown {slow[i].mean():.2f}")

    # -------- power-capped variant: the paper's grid limit as a hard
    # constraint.  The cap grid is ONE leaf-batched policy (power_cap is a
    # Policy leaf like K), simulated in one run on the event-granular core
    # with conservative backfilling.
    caps = np.array([45e3, 52e3, 60e3, np.inf], np.float32)
    print(f"\npower-capped campaign ({len(caps)}-cap grid, conservative "
          f"backfilling, one run) ...")
    wcap = make_stream_workload(JSCC_SYSTEMS, min(n_sim, 1000),
                                arrival="diurnal", rate=0.8, seed=3)
    res = Scheduler(make_policy("conservative", k=args.k, power_cap=caps),
                    warm_start=True, device=dev).run(wcap, totals_only=True)
    peak = res.peak_power.cpu().numpy()
    mk = res.makespan.cpu().numpy()
    cdel = res.capped_delay.cpu().numpy()
    idle = res.idle_energy.cpu().numpy()
    for i, cap in enumerate(caps):
        tag = "uncapped" if not np.isfinite(cap) else f"{cap/1e3:.0f} kW"
        print(f"  cap={tag:9s} peak={peak[i]/1e3:5.1f} kW  "
              f"makespan={mk[i]:7.1f} s  capped_delay={cdel[i]:7.1f} s  "
              f"idle_energy={idle[i]/1e6:.2f} MJ")
        if np.isfinite(cap):
            assert peak[i] <= cap * (1 + 1e-5)


if __name__ == "__main__":
    main()
