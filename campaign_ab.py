#!/usr/bin/env python3
"""Compare the campaign step of two trees of this repository on one card.

    mkdir -p build/ab_base && git archive <commit> | tar -x -C build/ab_base
    python3 campaign_ab.py --base build/ab_base [--pairs 12] [--mixed]

Each run is a fresh process that imports the port and ``chip_smoke.py``
from one tree, builds that tree's kth_free kernel, and runs
``chip_smoke.py``'s documented campaign (10,000 Poisson NPB jobs, 5 K x 4
seeds, stragglers and failures, warm start) twice on the card, timing
each run as ``chip_smoke.py --only campaign`` times its ``ms_per_step``:
the first run is the figure that phase reports, the second runs warm.
The base tree (``--base``) and this one (the change) alternate in ABBA
order over ``--pairs`` rounds.  ``--mixed`` adds the two crossings of
kernel and wrapper: the base tree's wrapper with the change's
``kth_free.cu``, and the change's wrapper with the base's (the C entry
takes the same arguments in both).

Every run must launch the kth_free kernel once per job and give the same
schedule (a digest of the placements and finish times) as every other.
Prints one JSON line per run, then per variant the median and
interquartile range of ms per step, then for each variant against the
base the paired differences (variant - base, each pair's runs adjacent),
their median, their mean with its 95% t interval, how many pairs read
the variant slower and the two-sided sign-test p-value; then the card's
name and power limit.  ``--out FILE`` also writes the run lines there,
and ``--summarize FILE`` prints the summary of such a file again.
``--device cpu`` runs the same on the CPU (the kernel's plain version,
no launches) to check the script.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
KTH_SOURCE = os.path.join("src", "repro_torch", "kernels", "kth_free",
                          "csrc", "kth_free.cu")


def child(tree: str, kernel_tree: str | None, jobs: int | None,
          device: str) -> dict:
    """One run in this process: the campaign of ``tree`` (its wrapper,
    engine and ``chip_smoke.py``), with the kth_free source of
    ``kernel_tree`` when given, timed twice."""
    tree = os.path.abspath(tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.core import JSCC_SYSTEMS
    from repro_torch.data import make_stream_workload
    from repro_torch.kernels import _build
    from repro_torch.kernels.kth_free import kth_free_cuda
    for mod in (cs, _build):
        if not os.path.abspath(mod.__file__).startswith(tree + os.sep):
            raise RuntimeError(f"{mod.__name__} imported from {mod.__file__}"
                               f", not from {tree}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if kernel_tree is not None:
            kernel = Path(kernel_tree).resolve() / KTH_SOURCE
            _build.SOURCES["kth_free"] = kernel
        _build.build(["kth_free"])
        sync = torch.cuda.synchronize
    else:
        def sync():
            pass
    jobs = cs.CAMPAIGN_J if jobs is None else jobs
    w = make_stream_workload(JSCC_SYSTEMS, jobs, "poisson", rate=0.5, seed=0)
    ms, launches = [], []
    for _ in range(2):
        before = kth_free_cuda.launches
        sync()
        t0 = time.perf_counter()
        res = cs._campaign(w, device=None if dev.type == "cuda" else dev)
        sync()
        ms.append((time.perf_counter() - t0) / jobs * 1e3)
        launches.append(kth_free_cuda.launches - before)
    if dev.type == "cuda" and launches != [jobs, jobs]:
        raise RuntimeError(f"kth_free launches {launches}, not {jobs} a run")
    digest = hashlib.sha256()
    for t in (res.system, res.finish, res.total_energy):
        digest.update(t.cpu().numpy().tobytes())
    return dict(ms_per_step=ms[0], ms_per_step_warm=ms[1],
                launches=launches, digest=digest.hexdigest()[:16])


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return dict(median=statistics.median(xs), q1=q[0], q3=q[2])


#: Student's t 0.975 quantiles for 1..30 degrees of freedom
_T975 = (12.706, 4.303, 3.182, 2.776, 2.571, 2.447, 2.365, 2.306, 2.262,
         2.228, 2.201, 2.179, 2.160, 2.145, 2.131, 2.120, 2.110, 2.101,
         2.093, 2.086, 2.080, 2.074, 2.069, 2.064, 2.060, 2.056, 2.052,
         2.048, 2.045, 2.042)


def _sign_p(slower: int, n: int) -> float:
    """Two-sided sign-test p-value of ``slower`` of ``n`` pairs."""
    k = min(slower, n - slower)
    return min(1.0, 2 * sum(math.comb(n, i) for i in range(k + 1)) / 2 ** n)


def summarize(runs: dict) -> dict:
    """Per variant the median and IQR of both timings; for each variant
    against ``base``, the paired differences, their median, mean and 95%
    t interval half-width, the pairs read slower and the sign-test p."""
    digests = {r["digest"] for rs in runs.values() for r in rs}
    if len(digests) != 1:
        raise RuntimeError(f"the runs' schedules differ: {sorted(digests)}")
    summary = {}
    for v, rs in runs.items():
        summary[v] = {key: _quartiles([r[key] for r in rs])
                      for key in ("ms_per_step", "ms_per_step_warm")}
        if v == "base":
            continue
        for key in ("ms_per_step", "ms_per_step_warm"):
            d = [a[key] - b[key] for a, b in zip(rs, runs["base"])]
            n, slower = len(d), sum(x > 0 for x in d)
            t = _T975[n - 2] if n - 1 <= len(_T975) else 1.96
            summary[v][key].update(
                diff_vs_base_median=statistics.median(d),
                diff_vs_base_mean=statistics.mean(d),
                diff_vs_base_ci95=t * statistics.stdev(d) / math.sqrt(n),
                diffs_vs_base=d, pairs_slower=slower, pairs=n,
                sign_test_p=_sign_p(slower, n))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", help="unpacked tree of the commit to compare "
                                   "this tree against")
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--mixed", action="store_true",
                    help="also cross the two trees' kernel and wrapper")
    ap.add_argument("--jobs", type=int, default=None,
                    help="campaign length (default chip_smoke's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--summarize", metavar="FILE", default=None,
                    help="print the summary of the run lines in FILE (an "
                         "earlier --out) and exit")
    ap.add_argument("--child", nargs=2, metavar=("TREE", "KERNEL_TREE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        tree, kernel_tree = args.child
        print(json.dumps(child(tree, None if kernel_tree == "-" else
                               kernel_tree, args.jobs, args.device)))
        return 0
    if args.summarize:
        runs = {}
        with open(args.summarize) as f:
            for line in f:
                rec = json.loads(line)
                runs.setdefault(rec["variant"], []).append(rec)
        runs = {v: sorted(rs, key=lambda r: r["pair"])
                for v, rs in runs.items()}
        print(json.dumps({"summary": summarize(runs),
                          "pairs": len(runs["base"])}))
        return 0
    if args.base is None or args.pairs < 2:
        ap.error("--base and at least two pairs are needed")
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("campaign_ab: no CUDA device", file=sys.stderr)
            return 2
    base = os.path.abspath(args.base)
    variants = {"base": (base, "-"), "change": (ROOT, "-")}
    if args.mixed:  # base and change stay adjacent in every round
        variants = {"base_wrapper+change_kernel": (base, ROOT), **variants,
                    "change_wrapper+base_kernel": (ROOT, base)}
    names = list(variants)
    runs = {v: [] for v in names}
    out = open(args.out, "w") if args.out else None
    for i in range(args.pairs):
        for v in (names if i % 2 == 0 else names[::-1]):
            tree, kernel_tree = variants[v]
            cmd = [sys.executable, os.path.abspath(__file__), "--child", tree,
                   kernel_tree, "--device", args.device]
            if args.jobs is not None:
                cmd += ["--jobs", str(args.jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  cwd=tree, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"run {v} (pair {i}) failed:\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            rec = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                       variant=v, pair=i)
            runs[v].append(rec)
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                print(line, file=out, flush=True)
    if out:
        out.close()
    print(json.dumps({"summary": summarize(runs), "pairs": args.pairs}),
          flush=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
