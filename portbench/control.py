#!/usr/bin/env python3
"""The comparison's control at a cell's own size: the reference put in
the program's place and computed in bfloat16, the precision below the
configuration's float32.

    python3 portbench/control.py --workload easy16.swf-contended \\
        --seeds 101,102,103 [--campaigns 4]

For each seed: the cell's stream and tables, the lanes a run's window
would compare (``--campaigns`` campaigns of the cell's R seeds, the
cell's lanes a campaign), the reference in float32 as the judge and in
bfloat16 as the program.  Prints one JSON line a seed with the numbers
compared, the cell's limits and the verdict, which has to be false.  It
needs no card and runs none of the port.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--campaigns", type=int, default=4)
    args = ap.parse_args(argv)

    from portbench import correct, generator, harness, spec
    cell = spec.cell(spec.load(ROOT), ROOT, args.workload, False)
    config, own = cell.config, cell.own
    jobs = int(config["jobs_per_campaign"])
    R = int(own["seeds_per_campaign"])
    B = len(config["k_grid"]) * R
    m = min(int(own["check"]["lanes_per_campaign"]), B)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        base = harness.seed_base(seed)
        s = generator.stream_seed(seed)
        traffic = generator.generate(cell.traffic, seed)
        tab = correct.reference_tables(traffic, config, jobs)
        pairs = [(int(i) // R, base + c * R + int(i) % R)
                 for c in range(1, args.campaigns + 1)
                 for i in correct.sample_lanes(s, c, B, m)]
        lanes = correct.lane_inputs(config, pairs)
        want = correct.reference_run(tab, config, lanes)
        got = correct.reference_run(tab, config, lanes, prec="bf16")
        numbers = {**correct.compare(got, want), "lanes_bad": 0}
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "lanes": len(pairs), "numbers": numbers,
                          "limits": own["limits"],
                          "correct": correct.verdict(numbers, own["limits"]),
                          "wrong_lanes": correct.wrong_lanes(
                              got, want, own["limits"]["totals_rel_gap"]),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
