#!/usr/bin/env python3
"""What the port's tracer costs when on: one cell's campaign of its
``trace_jobs`` jobs at the cell's lanes, host wall to a synchronise,
with the tracer off, on with every span timed on the stream
(``collect()``), and on as the span campaign runs it (only
``spans.TIMED`` timed), in turns (the order rotating each round), each
campaign on its own block of lane seeds.

    python3 portbench/span_cost.py --workload fcfs.npb-poisson --seed 7 \\
        --rounds 4

Run from the root of a checkout, on a CUDA card.  Prints one JSON line:
the walls in seconds by mode, each mode's median and its ratio to the
median with the tracer off.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell's name")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from portbench import generator, harness, program, spans, spec
    from repro_torch.utils import trace
    cell = spec.cell(spec.load(ROOT), ROOT, args.workload, True)
    config, own = cell.config, cell.own
    w = program.prefix(program.build_workload(
        generator.generate(cell.traffic, args.seed), config),
        int(own["trace_jobs"]))
    R = int(own["seeds_per_campaign"])
    base = harness.seed_base(args.seed)
    program.build_kernels()
    modes = {"off": None, "on_all": True, "on_timed": spans.TIMED}
    block = iter(range(len(modes) * args.rounds + 1))

    def campaign(mode: str) -> float:
        first = base + next(block) * R
        sched = program.scheduler(config, range(first, first + R), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if modes[mode] is None:
            program.run(sched, w, config)
        else:
            with trace.collect(device=modes[mode]):
                program.run(sched, w, config)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    campaign("off")                                  # warm
    walls = {m: [] for m in modes}
    order = list(modes)
    for i in range(args.rounds):
        for m in order[i % len(order):] + order[:i % len(order)]:
            walls[m].append(campaign(m))
    med = {m: statistics.median(v) for m, v in walls.items()}
    print(json.dumps({"cell": cell.name, "card": torch.cuda.get_device_name(),
                      "walls_s": walls, "median_s": med,
                      "over_off": {m: med[m] / med["off"] for m in modes}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
