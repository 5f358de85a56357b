#!/usr/bin/env python3
"""Sweep a cell's seeds per campaign R on the card, to fix its width.

    python3 portbench/sweep.py --workload easy16.swf-contended \\
        --seeds-per-campaign 256,1024,4096,16384,65536 --seed 11 \\
        [--out sweep.jsonl]

For each R (B = K grid x R lanes), in one process: a warm campaign of the
cell's warm jobs, a timed prefix of 200 jobs, and, where the prefix
predicts a whole campaign within ``--max-campaign-s``, two whole campaigns
timed apart (host clock, synchronised).  Prints one JSON line a point:
seconds a campaign, lane-jobs a second, the device memory peak; a point
that runs out of memory says so.  A cell takes a point near the sweep's
highest rate whose campaign ends within a run's time and whose peak stays
under half the card, and where the device's step clearly outlasts the
host's dispatch, so that the host's jitter does not reach the rate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds-per-campaign",
                    default="256,1024,4096,16384,65536")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--max-campaign-s", type=float, default=20.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from portbench import generator, harness, program, spec
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = spec.cell(spec.load(ROOT), ROOT, args.workload, False)
    config = cell.config
    jobs = int(config["jobs_per_campaign"])
    w_all = program.build_workload(
        generator.generate(cell.traffic, args.seed), config)
    w = program.prefix(w_all, jobs)
    program.build_kernels()
    steps = harness.steps_per_campaign(config, jobs)
    G = len(config["k_grid"])

    def timed(sched, wl):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program.run(sched, wl, config)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    seed0 = 0
    for R in (int(r) for r in args.seeds_per_campaign.split(",")):
        B = G * R
        row = {"workload": cell.name, "R": R, "lanes": B, "jobs": jobs}
        sched = lambda: program.scheduler(  # noqa: E731
            config, range(seed0, seed0 + R), "cuda")
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            timed(sched(), program.prefix(w_all, int(cell.own["warm_jobs"])))
            n = 200
            pre = timed(sched(), program.prefix(w_all, n))
            row["prefix_ms_per_step"] = pre / harness.steps_per_campaign(
                config, n) * 1e3
            guess = pre / harness.steps_per_campaign(config, n) * steps
            row["campaign_s_predicted"] = guess
            if guess <= args.max_campaign_s:
                secs = [timed(sched(), w) for _ in range(2)]
                row["campaign_s"] = secs
                row["ms_per_step"] = [s / steps * 1e3 for s in secs]
                row["lane_jobs_per_s"] = [jobs * B / s for s in secs]
            row["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        except torch.cuda.OutOfMemoryError as e:
            row["out_of_memory"] = str(e).splitlines()[0][:200]
        seed0 += R
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
