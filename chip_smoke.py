#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  build        compile every CUDA kernel of the port (one ``nvcc`` per
               source, all started together) and record the toolchain
  kernel       every kernel against its plain torch twin and the sort
               oracle (``torch.equal``) at the shapes the path gives it,
               with edge rows; kernel / twin / library times and the bound
  paper        the paper's NPB K sweep; the paper-claim assertions hold
  campaign     the documented campaign: 10,000 Poisson NPB jobs at rate
               0.5, K in {0, .05, .1, .2, .3} x 4 seeds, stragglers and
               failures, warm start, full and totals_only.  The kernel's
               launch count rises by exactly J per run, the twin placer
               gives bit-equal results, and the step loop makes no host
               synchronisation
  cross_device the first 1,000 jobs on the CPU (twin) against the card
               (kernel) within the parity bands of PERF.md

Then a ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and no result line is printed.  Without a CUDA device
the script exits non-zero before doing anything.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM published rates: HBM bytes/s and
#: non-tensor-core float32 operations/s.
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12
BIG = 1e30
CAMPAIGN_KS = (0.0, 0.05, 0.1, 0.2, 0.3)
CAMPAIGN_SEEDS = (0, 1, 2, 3)
CAMPAIGN_J = 10_000


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn`` over ``iters`` calls
    (CUDA events around the whole run, after a warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _kernel_device_us(fn, name: str, iters: int = 200):
    """Mean device execution time (µs) of the CUDA kernels whose name
    contains ``name`` over ``iters`` calls of ``fn``, from a profiler
    trace: the kernel alone, without the host's launch gaps that the
    back-to-back event timing includes.  None if the trace is empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time_total for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name in e.name]
    return sum(times) / len(times) if times else None


def phase_build() -> dict:
    import torch
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build()
    seconds = time.perf_counter() - t0
    nvcc_version = subprocess.run([_build.nvcc(), "--version"],
                                  capture_output=True, text=True,
                                  timeout=60).stdout.strip().splitlines()[-1]
    emit("build", seconds=seconds, kernels=sorted(report),
         ptxas={k: [ln for ln in v["log"].splitlines() if "Used" in ln]
                for k, v in report.items()},
         python=sys.version.split()[0], torch=torch.__version__,
         torch_cuda=torch.version.cuda, nvcc=nvcc_version,
         device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi())
    return report


def _kth_case(shape, seed, device):
    import torch
    g = torch.Generator().manual_seed(seed)
    free = torch.rand(shape, generator=g) * 1e6
    free[torch.rand(shape, generator=g) < 0.3] = BIG
    free[torch.rand(shape, generator=g) < 0.3] = 0.0
    nreq = torch.randint(1, shape[-1] + 1, shape[:-1], generator=g,
                         dtype=torch.int32)
    return free.to(device), nreq.to(device)


def phase_kernel() -> dict:
    """The CUDA kth-free kernel against its twin and the sort oracle."""
    import torch
    from repro_torch.kernels.kth_free import (kth_free_cuda, kth_free_ref,
                                              radix_select_kth)
    dev = torch.device("cuda")
    cases = {}
    cases["slice"] = _kth_case((20, 4, 136), 0, dev)         # campaign step
    cases["easy"] = _kth_case((20, 17, 4, 136), 1, dev)      # EASY window
    free, nreq = _kth_case((20, 4, 136), 2, dev)
    free[0] = BIG                                            # all-BIG rows
    free[1] = torch.randint(0, 3, free[1].shape, device=dev).float()  # ties
    free[2] = -torch.rand(free[2].shape, device=dev) * 1e3   # negative times
    free[3, :, ::2] = -0.5
    nreq[4] = 0                                              # clip below
    nreq[5] = -7
    nreq[6] = 137                                            # clip above
    nreq[7] = 10 ** 6
    cases["edges"] = (free, nreq)
    cases["wide"] = _kth_case((3, 7, 1000), 3, dev)          # smem path
    cases["narrow"] = _kth_case((5, 3, 20), 4, dev)
    max_err = 0.0
    for name, (free, nreq) in cases.items():
        out = kth_free_cuda(free, nreq)
        torch.cuda.synchronize()
        twin = radix_select_kth(free, nreq)
        srt = kth_free_ref(free, nreq)
        check(torch.equal(out, twin), f"kth_free kernel != twin ({name})")
        check(torch.equal(out, srt), f"kth_free kernel != sort ({name})")
        check(torch.equal(out.cpu(), kth_free_ref(free.cpu(), nreq.cpu())),
              f"kth_free kernel != CPU sort ({name})")
        max_err = max(max_err, float((out - twin).abs().max()))

    free, nreq = cases["slice"]
    rows, n = nreq.numel(), free.shape[-1]
    kernel_ms = cuda_ms(lambda: kth_free_cuda(free, nreq), 2000)
    twin_ms = cuda_ms(lambda: radix_select_kth(free, nreq), 50)
    idx = (nreq.long() - 1).clamp(0, n - 1).unsqueeze(-1)
    lib_ms = cuda_ms(lambda: torch.sort(free, -1).values.gather(-1, idx),
                     500)
    easy_free, easy_nreq = cases["easy"]
    easy_ms = cuda_ms(lambda: kth_free_cuda(easy_free, easy_nreq), 2000)
    device_us = _kernel_device_us(lambda: kth_free_cuda(free, nreq),
                                  "kth_free")
    # least time for the work: each input byte read once, each output
    # written once; 32 compare-and-count passes over every key
    bytes_moved = free.numel() * 4 + rows * 4 + rows * 4
    ops = 32 * free.numel() * 2
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / VECTOR_OPS_PER_S * 1e3
    res = dict(shape=list(free.shape), kernel_us=kernel_ms * 1e3,
               kernel_device_us=device_us,
               twin_us=twin_ms * 1e3, sort_gather_us=lib_ms * 1e3,
               easy_shape=list(easy_free.shape), easy_kernel_us=easy_ms * 1e3,
               bound_us=max(bytes_ms, ops_ms) * 1e3,
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bytes=bytes_moved, ops=ops, max_abs_err=max_err,
               cases=sorted(cases), launches_so_far=kth_free_cuda.launches)
    emit("kernel", **res)
    return res


def phase_paper() -> None:
    import numpy as np
    import torch
    from repro_torch.core import JSCC_SYSTEMS, Scheduler, make_npb_workload
    from repro_torch.core.policy import make_policy
    w = make_npb_workload(JSCC_SYSTEMS)
    ks = np.array([0.0, 0.05, 0.10, 0.20, 0.85], np.float32)
    res = Scheduler(make_policy("paper", k=ks), warm_start=True).run(w)
    torch.cuda.synchronize()
    E = res.total_energy.cpu().numpy().astype(np.float64)
    M = res.makespan.cpu().numpy().astype(np.float64)
    sel = res.system.cpu().numpy()
    dE, dM = (E - E[0]) / E[0], (M - M[0]) / M[0]
    check(dE[1:4].min() <= -0.12, f">=12% saving at some K in [.05,.2]: {dE}")
    check(dM[1:4].max() <= 0.10, f"<=10% makespan increase: {dM}")
    check((E[0] - E[2]) / E[0] >= 0.10, "saving at K=.10 >= 10%")
    names = [w.programs[p] for p in w.prog]
    switched = {names[j]: bool(sel[0, j] != sel[1, j])
                for j in range(len(names))}
    lu = names.index("LU")
    check(not switched["LU"], "LU must not switch at K=5%")
    check(sum(switched.values()) >= 3, f"most switch at K=5%: {switched}")
    check(sel[4, lu] != sel[0, lu], "LU switches at K=85%")
    check(bool((np.diff(E) <= 1e-6).all()), f"energy monotone in K: {E}")
    emit("paper", device=str(res.total_energy.device), ks=ks.tolist(),
         energy_saving=(-dE).tolist(), makespan_increase=dM.tolist(),
         placements=sel.tolist())


def _campaign(w, placer=None, device=None, totals_only=False):
    import numpy as np
    from repro_torch.core import FaultConfig, Scheduler
    from repro_torch.core.policy import make_policy
    pol = make_policy("paper", k=np.array(CAMPAIGN_KS, np.float32))
    sched = Scheduler(pol, seeds=CAMPAIGN_SEEDS, warm_start=True,
                      faults=FaultConfig(straggler_prob=0.05,
                                         failure_prob=0.01),
                      placer=placer, device=device)
    return sched.run(w, totals_only=totals_only)


def _timed_campaign(w, **kw):
    import torch
    from repro_torch.kernels.kth_free import kth_free_cuda
    torch.cuda.synchronize()
    before = kth_free_cuda.launches
    t0 = time.perf_counter()
    res = _campaign(w, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, kth_free_cuda.launches - before


def _prefix(w, n):
    """The first ``n`` jobs of a stream workload."""
    import dataclasses
    return dataclasses.replace(w, prog=w.prog[:n], arrival=w.arrival[:n],
                               k_job=w.k_job[:n])


def _sync_count(fn):
    """Number of host synchronisations ``fn()`` makes, counted by
    PyTorch's sync debug mode."""
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(c.message) for c in caught)


def _launches_per_step(w_small):
    """CUDA kernels launched per step, from a profiler trace of a short
    run (None when the profiler records no device kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    _campaign(w_small)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _campaign(w_small)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None, None
    busy_us = sum(e.device_time_total for e in kernels)
    return len(kernels) / len(w_small.prog), busy_us / len(w_small.prog)


def phase_campaign(counters: dict) -> dict:
    """The documented campaign on the card: the main path."""
    import torch
    from repro_torch.core import JSCC_SYSTEMS
    from repro_torch.data import make_stream_workload
    from repro_torch.kernels.kth_free import kth_free_cuda
    w = make_stream_workload(JSCC_SYSTEMS, CAMPAIGN_J, "poisson", rate=0.5,
                             seed=0)
    J, B = CAMPAIGN_J, len(CAMPAIGN_KS) * len(CAMPAIGN_SEEDS)

    # the main path: every count to 0 just before, read just after
    kth_free_cuda.launches = 0
    full, t_full, _ = _timed_campaign(w)
    counters["kth_free"] = kth_free_cuda.launches
    check(counters["kth_free"] == J,
          f"kth_free launches {counters['kth_free']} != J={J}")

    tot, t_tot, n_tot = _timed_campaign(w, totals_only=True)
    check(n_tot == J, f"totals_only launches {n_tot} != J={J}")
    twin, t_twin, n_twin = _timed_campaign(w, placer="torch")
    check(n_twin == 0, "placer='torch' must not launch the kernel")
    for f in ("system", "start", "finish", "wait", "energy", "runtime",
              "total_energy", "total_wait", "slowdown_sum", "makespan",
              "busy", "idle_energy", "C_tab", "T_tab", "runs"):
        check(torch.equal(getattr(full, f), getattr(twin, f)),
              f"kernel and twin placers differ on {f}")
    for f in ("makespan", "max_wait", "busy", "C_tab", "T_tab", "runs",
              "idle_energy"):
        check(torch.equal(getattr(full, f), getattr(tot, f)),
              f"totals_only differs from full on {f}")
    for f in ("total_energy", "total_wait", "slowdown_sum"):
        a, b = getattr(full, f).double(), getattr(tot, f).double()
        check(bool(((a - b).abs() <= 1e-5 * b.abs()).all()),
              f"Kahan {f} departs from the full-path sum")
    check(bool(torch.isfinite(full.finish).all()), "finite finish times")
    check(bool((full.start >= torch.as_tensor(
        w.arrival, device=full.start.device)).all()),
        "no job starts before it arrives")

    # the detector sees a sync (one .item()), and a run's syncs do not
    # grow with the number of steps
    probe = _sync_count(lambda: torch.ones(1, device="cuda").sum().item())
    check(probe >= 1, "sync debug mode reports no sync for .item()")
    syncs = {n: _sync_count(lambda: _campaign(_prefix(w, n)))
             for n in (200, 400)}
    check(syncs[200] == syncs[400],
          f"host syncs grow with J (no sync allowed in the step): {syncs}")
    per_step, busy_us = _launches_per_step(_prefix(w, 200))
    step_us = t_full / J * 1e6
    res = dict(jobs=J, lanes=B, seconds_full=t_full,
               seconds_totals_only=t_tot, seconds_twin_placer=t_twin,
               ms_per_step=t_full / J * 1e3,
               ms_per_step_totals_only=t_tot / J * 1e3,
               ms_per_step_twin_placer=t_twin / J * 1e3,
               jobs_per_s=J * B / t_full,
               jobs_per_s_totals_only=J * B / t_tot,
               kth_free_launches_per_step=counters["kth_free"] / J,
               cuda_launches_per_step=per_step,
               device_busy_us_per_step=busy_us,
               device_idle_share=(None if busy_us is None
                                  else 1.0 - busy_us / step_us),
               host_syncs_per_run=syncs, sync_probe_item=probe,
               total_energy=full.total_energy.flatten().tolist(),
               makespan=full.makespan.flatten().tolist())
    emit("campaign", **res)
    return res


def phase_cross_device() -> None:
    """The first 1,000 jobs of the campaign on the CPU (twin) and the card
    (kernel): placements and per-job values exact, reductions over jobs
    within rtol 1e-6 (torch.sum adds in another order on each device)."""
    import numpy as np
    from repro_torch.core import JSCC_SYSTEMS
    from repro_torch.data import make_stream_workload
    w = _prefix(make_stream_workload(JSCC_SYSTEMS, CAMPAIGN_J, "poisson",
                                     rate=0.5, seed=0), 1000)
    for totals_only in (False, True):
        cpu = _campaign(w, device="cpu", totals_only=totals_only)
        gpu = _campaign(w, totals_only=totals_only)
        banded = () if totals_only else ("total_energy", "total_wait",
                                         "slowdown_sum")
        worst = 0.0
        for f in ("system", "tier", "nodes", "start", "finish", "wait",
                  "energy", "runtime", "C_tab", "T_tab", "runs", "busy",
                  "makespan", "max_wait", "idle_energy", "total_energy",
                  "total_wait", "slowdown_sum"):
            a = getattr(cpu, f)
            if a is None:
                continue
            a, b = a.numpy(), getattr(gpu, f).cpu().numpy()
            if f in banded:
                rel = np.abs(a.astype(np.float64) - b) / np.abs(a)
                worst = max(worst, float(rel.max()))
                check(bool((rel <= 1e-6).all()), f"cpu/cuda {f} rel {rel}")
            else:
                check(np.array_equal(a, b), f"cpu/cuda {f} differ")
        emit("cross_device", jobs=1000, totals_only=totals_only,
             exact="all but " + ",".join(banded) if banded else "all",
             worst_rel_reduction=worst)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on "
              "the card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_build()
    kern = phase_kernel()
    phase_paper()
    counters: dict = {}
    camp = phase_campaign(counters)
    phase_cross_device()
    kernels = [{
        "name": "kth_free",
        "route": "cuda",
        "source": "src/repro_torch/kernels/kth_free/csrc/kth_free.cu",
        "replaces": "src/repro/kernels/kth_free/kernel.py:81",
        "launches": counters["kth_free"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["kernel_us"] / 1e3,
        "device_ms": (None if kern["kernel_device_us"] is None
                      else kern["kernel_device_us"] / 1e3),
        "plain_ms": kern["twin_us"] / 1e3,
        "bound_ms": kern["bound_us"] / 1e3,
        "bound_by": kern["bound_by"],
        "library_ms": kern["sort_gather_us"] / 1e3,
        "library": "torch.sort + gather (two calls)",
        "check": "torch.equal vs twin and sort",
    }]
    emit("done", seconds=time.perf_counter() - t_start,
         campaign_ms_per_step=camp["ms_per_step"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
