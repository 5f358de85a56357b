"""Scheduler CLI: run the port's scheduler on a job stream or campaign,
with the reference's options and output lines
(``python -m repro.launch.schedule``).

    PYTHONPATH=src python -m repro_torch.launch.schedule --device cpu
    PYTHONPATH=src python -m repro_torch.launch.schedule --device cpu \
        --jobs 200 --queue easy_backfill:window=16
    PYTHONPATH=src python -m repro_torch.launch.schedule --device cpu \
        --jobs 200 --scenario diurnal --queue conservative:window=16
    PYTHONPATH=src python -m repro_torch.launch.schedule --device cpu \
        --jobs 200 --scenario bursty --queue conservative --power-cap 60000
    PYTHONPATH=src python -m repro_torch.launch.schedule --sweep-k 0,0.1,0.2
    PYTHONPATH=src python -m repro_torch.launch.schedule \
        --trace tests/data/jscc_sample.swf.gz \
        --queue easy_backfill:window=16 --campaign-k 0,0.1,0.3 \
        --campaign-seeds 2
    PYTHONPATH=src python -m repro_torch.launch.schedule --device cpu \
        --jobs 5000 --campaign-k 0,0.1 --campaign-seeds 2 --totals-only \
        --shards auto --chunk 1024          # sharded + chunked campaign

Runs on the CUDA device by default (``--device cuda``) and raises without
one; ``--device cpu`` runs the same code on the CPU.

Modes, as in the reference: the paper's NPB suite (no stream option), a
K sweep (``--sweep-k``), a campaign grid in one ``Scheduler.run``
(``--campaign-k`` x ``--campaign-seeds``), a synthetic stream (``--jobs``
with ``--scenario``), SWF trace replay (``--trace``, ``.gz`` ok;
``--calibrate-trace`` maps classes through the phase model) and
maintenance windows (``--outage S:START:END``, repeatable).  Queue
disciplines: ``fcfs``, ``easy_backfill[:window=W]`` and
``conservative[:window=W]``; an SCC power cap (``--power-cap WATTS``)
and ``--engine events`` run on the event-granular core, which also
prints the ``peak_power`` / ``capped_delay`` / ``idle_energy`` line.
Campaign scale: ``--shards auto|N`` splits the grid's lanes over the
local devices and ``--chunk SIZE`` runs the steps in SIZE-step windows
(with ``--totals-only``, memory flat in the number of jobs).
``--easy-eval unrolled`` runs the reference's per-slot EASY loop
(2 W + 2 kth-free calls a step, the same placements).
``--spans-out PATH`` runs under the port's tracer (``utils/trace``) and
writes its spans as Chrome-trace JSON (host spans on one track, their
stream intervals on another, on the card), for ``chrome://tracing`` or
Perfetto:

    PYTHONPATH=src python -m repro_torch.launch.schedule --device cpu \
        --jobs 200 --queue easy_backfill:window=16 --spans-out spans.json
"""

from __future__ import annotations

import argparse
from dataclasses import replace

import numpy as np

from repro_torch.core import (JSCC_SYSTEMS, FaultConfig, Scheduler,
                              make_npb_workload)
from repro_torch.core.cliargs import (add_policy_options, add_scale_options,
                                      build_engine, build_policy,
                                      build_scale)
from repro_torch.data.scenarios import (ARRIVAL_KINDS, NPB_LARGE, NPB_SMALL,
                                        load_swf, maintenance_windows,
                                        make_stream_workload,
                                        workload_from_trace)
from repro_torch.utils import trace


def _parse_outages(specs, n_systems):
    if not specs:
        return None
    spans = {}
    for spec in specs:
        s, a, b = spec.split(":")
        spans.setdefault(int(s), []).append((float(a), float(b)))
    return maintenance_windows(n_systems, spans)


def build_workload(args):
    """The ``Workload`` the options describe: an SWF trace, a synthetic
    stream, or the paper's NPB suite."""
    outage = _parse_outages(args.outage, len(JSCC_SYSTEMS))
    if args.trace:
        w = workload_from_trace(load_swf(args.trace), JSCC_SYSTEMS,
                                calibrate=args.calibrate_trace)
        if outage is not None:
            w = replace(w, outage=outage)
        return w
    if args.jobs:
        mix = {NPB_SMALL: args.mix_small, NPB_LARGE: 1.0 - args.mix_small}
        return make_stream_workload(
            JSCC_SYSTEMS, args.jobs, arrival=args.scenario,
            rate=args.arrival_rate, mix=mix, seed=args.seed, outage=outage)
    return make_npb_workload(JSCC_SYSTEMS, outage=outage)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def main(argv=None):
    """Parse ``argv``, run, print the reference's lines; returns the
    result (``SimResult`` or ``CampaignResult``)."""
    ap = argparse.ArgumentParser()
    add_policy_options(ap, engine=True)     # the shared grammar (cliargs)
    add_scale_options(ap)                   # --shards / --chunk
    ap.add_argument("--easy-eval", default="batched",
                    choices=("batched", "unrolled"),
                    help="EASY candidate evaluation: batched (one [W, S] "
                         "kth-free call per step) or the historical "
                         "unrolled per-slot loop (the same placements, "
                         "~W x slower; debugging/A-B only)")
    ap.add_argument("--sweep-k", default="",
                    help="comma-separated K values (fractions)")
    ap.add_argument("--jobs", type=int, default=0,
                    help="stream length (default: the paper's 5-job suite)")
    ap.add_argument("--scenario", default="poisson", choices=ARRIVAL_KINDS,
                    help="arrival process for --jobs streams")
    ap.add_argument("--arrival-rate", type=float, default=0.125,
                    help="mean arrivals per second (0 = simultaneous)")
    ap.add_argument("--mix-small", type=float, default=0.5,
                    help="weight of the small NPB job-size class")
    ap.add_argument("--trace", default="",
                    help="SWF trace file to replay instead of synthetic "
                         "jobs (.gz transparently gunzipped)")
    ap.add_argument("--calibrate-trace", action="store_true",
                    help="calibrate replayed job classes against the "
                         "phase model (workload_model.predict_phases) "
                         "instead of raw node throughput")
    ap.add_argument("--outage", action="append", default=[],
                    metavar="S:T0:T1",
                    help="maintenance window on system S (repeatable)")
    ap.add_argument("--campaign-k", default="",
                    help="comma-separated K grid -> one-run campaign")
    ap.add_argument("--campaign-seeds", type=int, default=0,
                    help="number of seeds in the campaign grid")
    ap.add_argument("--totals-only", action="store_true",
                    help="campaign memory: aggregate metrics only, no "
                         "per-job arrays (for huge job x grid products)")
    ap.add_argument("--cold", action="store_true",
                    help="empty profile tables (exploration phase)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--spans-out", default="", metavar="PATH",
                    help="record the run's spans and counters and write "
                         "them as Chrome-trace JSON to PATH")
    args = ap.parse_args(argv)
    if not args.spans_out:
        return _run(args)
    on_card = args.device is None or str(args.device).startswith("cuda")
    with trace.collect(device=on_card) as rec:
        res = _run(args)
    rec.write_chrome_trace(args.spans_out)
    return res


def _run(args):
    """Run what ``args`` describe and print the reference's lines."""
    w = build_workload(args)
    pol = build_policy(args)
    common = dict(faults=FaultConfig(straggler_prob=args.stragglers,
                                     failure_prob=args.failures),
                  warm_start=not args.cold, engine=build_engine(args),
                  easy_eval=args.easy_eval, device=args.device,
                  **build_scale(args))

    if args.campaign_k:
        ks = np.array([float(x) for x in args.campaign_k.split(",")],
                      np.float32)
        seeds = [args.seed + i for i in range(max(args.campaign_seeds, 1))]
        res = Scheduler(pol.with_params(k=ks), seeds=seeds, **common).run(
            w, totals_only=args.totals_only)
        E = _np(res.total_energy)                   # [K, R]
        M = _np(res.makespan)
        W = _np(res.total_wait)
        print(f"campaign: jobs={res.n_jobs} grid={len(ks)}Kx{len(seeds)}seed "
              f"policy={pol.name} axes={res.axes}")
        print("K,energy_J(mean),energy_J(std),makespan_s(mean),wait_s(mean),dE%")
        for i, k in enumerate(ks):
            print(f"{k:.2f},{E[i].mean():.0f},{E[i].std():.0f},"
                  f"{M[i].mean():.1f},{W[i].mean():.1f},"
                  f"{100*(E[i].mean()-E[0].mean())/E[0].mean():+.1f}")
        return res

    if args.sweep_k:
        ks = np.array([float(x) for x in args.sweep_k.split(",")], np.float32)
        res = Scheduler(pol.with_params(k=ks), seeds=args.seed,
                        **common).run(w)
        E = _np(res.total_energy)
        M = _np(res.makespan)
        print("K,energy_J,makespan_s,dE%,dT%")
        for i, k in enumerate(ks):
            print(f"{k:.2f},{E[i]:.0f},{M[i]:.1f},"
                  f"{100*(E[i]-E[0])/E[0]:+.1f},{100*(M[i]-M[0])/M[0]:+.1f}")
        return res

    r = Scheduler(pol, seeds=args.seed, **common).run(w)
    sel = _np(r.system)
    k_str = np.format_float_positional(float(np.asarray(pol.k)), trim="-")
    q_str = pol.queue if pol.queue == "fcfs" else \
        f"{pol.queue}(window={pol.window})"
    print(f"policy={pol.name} K={k_str} queue={q_str} jobs={r.n_jobs} "
          f"warm={not args.cold}")
    print(f"energy={float(r.total_energy)/1e3:.1f} kJ  "
          f"makespan={float(r.makespan):.1f} s  "
          f"total_wait={float(r.total_wait):.1f} s  "
          f"mean_slowdown={float(r.mean_slowdown):.2f}  "
          f"backfill_rate={float(r.backfill_rate):.1%}")
    peak = float(r.peak_power)
    if not np.isnan(peak):                 # event-granular core: SCC power
        cap_str = f"{args.power_cap:.0f} W" if args.power_cap else "none"
        print(f"peak_power={peak/1e3:.1f} kW (cap {cap_str})  "
              f"capped_delay={float(r.capped_delay):.1f} s  "
              f"idle_energy={float(r.idle_energy)/1e3:.1f} kJ")
    counts = np.bincount(sel, minlength=len(w.systems))
    print("placements:", {w.systems[i]: int(c) for i, c in enumerate(counts)})
    util = _np(r.utilization)
    print("utilization:", {w.systems[i]: f"{u:.1%}" for i, u in enumerate(util)})
    return r


if __name__ == "__main__":
    main()
