#!/usr/bin/env python3
"""The port's benchmark: one run of one cell on one CUDA card.

    python3 portbench/run.py --workload fcfs.npb-poisson --seed 7 \\
        --seconds 10 --trace 0

Run from the root of a checkout.  The cell's configuration, traffic mix,
sizes and metric readers are found by name from ``BENCHMARK.json``
(``portbench/spec.py``).  The window runs whole campaigns of the port's
``Scheduler`` back to back for ``--seconds`` (the last one finished);
``--trace 1`` then profiles one short campaign and reports the per-layer
metrics instead of the end-to-end ones.  Every run compares a seed-drawn
sample of its lanes with the plain numpy reference, prints each number
compared beside its limit as the last lines of standard error, and prints
one JSON result line last on standard output.

Exits non-zero and prints no result without enough CUDA devices, or when
the process holds a module of JAX or of the JAX package.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# every cache a run writes stays at a fixed path in the checkout (the port
# builds its kernels into build/torch_kernels/ by itself)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell's name")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True,
                    help="the measured window (the last campaign runs on)")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness, spec
    bench = spec.load(ROOT)
    cell = spec.cell(bench, ROOT, args.workload, bool(args.trace))

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"cell {cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device="cuda", t_process=T_PROCESS,
                            log=lambda s: print(s, file=sys.stderr,
                                                flush=True))
    found = harness.banned_modules()
    if found:
        print(f"the process holds {found}: the benchmark runs the port "
              "alone", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
