#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  build        compile every CUDA kernel of the port (one ``nvcc`` per
               source, all started together) and record the toolchain
  kernel       every kernel against its plain torch version
               (``torch.equal``; EP's sums within rtol 1e-6) at the shapes
               the paths give it and at edge cases; kth_free also against
               the sort oracle; EP's draw pass [16, 2, 2^16] into a
               non-zero carry and against its per-batch calls; is_hist
               also on keys[1:] (not 16-byte aligned), 3, 1,001 and
               2^24 + 3 keys and SMEM_BUCKETS + 1 buckets; kth_free at
               the EASY step's two shapes too, the window [20, 17, 4, 136]
               and the head recheck [20, 17, 136], and at the conservative
               core's realizability rows [4, 17, 136]; stencil7 also
               on grids whose edges cut its tiles (5x7x33, 64x1x64,
               3x64x5, 1x1x1).
               Kernel (events, back to back) / host (enqueue, no sync) /
               device / plain / library times, the bound and the launch
               floor (a 1-element ``add_``), one line per kernel; for
               is_hist and stencil7 also the wrapper's host time by step
               and is_hist's device time by kernel (memset, count); then
               a ``kernel_host`` line: the host µs of the launch floor and
               the kth_free, is_hist and stencil7 wrappers, in turns
  kernel_flash the flash attention kernel against its blocked plain version
               and the plain-softmax oracle (atol 3e-5 in f32, 3e-2 in
               bf16, and bf16 also within 2 bf16 ulps of |ref| + 1e-4) at
               the serving path's shape (q [4, 4096, 32, 64], k/v
               [4, 4096, 4, 64], causal, bf16 and f32), the reference's
               test shapes (causal and not, sk != sq, MQA, head dims
               32/64/128/256, f32 and bf16) and strided views (fused QKV,
               head-major, f32 and bf16); the route each case took (bf16
               at head dims 64 and 128: the tensor-core kernel, else the
               f32-core one); kernel / host / device / plain /
               ``F.scaled_dot_product_attention`` times, the bound and the
               tensor-core route's issued-operation floor, and one b = 1,
               s = 32,768 call with its last rows checked
  kernel_ssd   the SSD chunk-scan kernel against its plain version: the
               reference's test shapes (atol 2e-4, f32 and bf16), its
               chunk-invariance case (16 vs 64), the mamba2-780m path shape
               (x [4, 4096, 48, 64], B/C [4, 4096, 1, 128], chunk 256,
               bf16 and f32, as strided model-layout views; within 2e-4 +
               1e-4 max |plain|, and bit-equal to its run on contiguous
               copies) and one b = 1, l = 32,768 call; the route (bf16:
               four tensor-core launches, f32: three f32-core ones);
               kernel / host / device / per-launch device / plain times,
               the bound and the tensor-core route's issued-operation
               floor (no single PyTorch call computes an SSD scan)
  paper        the paper's NPB K sweep; the paper-claim assertions hold
  campaign     the documented campaign: 10,000 Poisson NPB jobs at rate
               0.5, K in {0, .05, .1, .2, .3} x 4 seeds, stragglers and
               failures, warm start, full and totals_only.  The kernel's
               launch count rises by exactly J per run, the twin placer
               gives bit-equal results, and the step loop makes no host
               synchronisation
  easy_campaign  EASY backfilling, window 16, on the reference ablation's
               contended SWF stream (``synthetic_swf_arrays(10_000)``
               through ``swf_lines``/``load_swf``/``workload_from_trace``,
               the four JSCC systems), the campaign's grid (20 lanes),
               faults and warm start: the full 10,016-step run launches
               the kernel exactly 2 (J + W) times, every lane backfills,
               EASY's mean total wait over the lanes is below FCFS's on
               the same stream (every lane printed); on the first 2,000
               jobs the ``sort`` placer is bit-equal and ``totals_only``
               keeps the same totals; the step makes no host sync; ms per
               step, jobs/s, launches and device µs per step, idle share
  event_campaign  the event-granular cores at the SCC's full width (four
               JSCC systems, maxN 136, window 16): the cluster draw added
               in the reference's order by ``segment_reduce`` equals one
               add per element; (a) FCFS on the event clock with failure
               re-queue on the campaign's stream cut to 500 jobs, its
               grid (20 lanes) and faults, one kth_free launch a step
               (3,504), ``sort`` placer bit-equal and ``totals_only``
               totals equal; (b) the same 500 jobs with stragglers only
               (2,004 steps), bit-equal to the arrival core's FCFS; (c)
               event EASY on them, two launches a step; (d) the
               example's capped conservative campaign (1,000 diurnal
               jobs, caps 45/52/60 kW and none), one rows launch a step
               (5,004): peaks under the caps, makespan non-decreasing as
               the cap tightens; on its first 500 jobs ``totals_only``
               equal and the uncapped lane equal to an uncapped run;
               each with no host sync in the
               step (two short prefixes make as many syncs), ms per step,
               jobs/s, launches and device µs per step by kernel, idle
               share; (e) conservative's mean wait below EASY's on the
               reference ablation's two streams; (f) the DVFS cap x
               freq_weight x K lattice: binding caps hold, tier counts
  cross_device the first 1,000 jobs on the CPU (twin) against the card
               (kernel) within the parity bands of PERF.md; the first
               500 jobs of the EASY stream, full and totals_only; and the
               first 500 jobs of event_campaign's runs (a) and (d)
  schedule_cli ``repro_torch.launch.schedule.main`` on the card: the paper
               suite, ``--jobs 200 --scenario diurnal --queue
               easy_backfill:window=16``, the SWF fixture as an EASY
               campaign (K 0, .1, .3 x 2 seeds), and the reference's
               conservative spellings ``--jobs 200 --scenario bursty
               --queue conservative --power-cap 60000`` and ``--jobs 200
               --scenario diurnal --queue conservative:window=16`` print
               the facade's totals on the same inputs, the conservative
               ones also its ``peak_power`` line
  workloads    the NPB analogues (EP, IS, BT, SP, LU) through
               ``run_benchmark`` at ``small`` and at NPB class A sizes
               (``A``; BT/SP/LU, whose ``small`` is their ``A``, run
               once): each verifies, launches its kernel the expected
               number of times and equals its ``force="torch"`` run (EP's
               sums within rtol 1e-6); wall time, Mop/s, device idle share
  executed_campaign  28 sampled NPB jobs placed by ``select_system`` over a
               ``ProfileStore`` (modes paper, fastest, first_free; K = 0.10;
               Skylake degraded x3 after job 14), each job executed on the
               card at ``smoke`` size and verified; energy and makespan
  serve        tinyllama-1.1b at full width (22 x 2048, bf16, seeded
               weights): a 4 x 4,096-token ``prefill`` launches the flash
               kernel once per layer (the tensor-core route; f32: the
               f32-core one) and agrees with its ``force="torch"``
               run within the band of ``SERVE_CELLS``, also in f32; a
               1,024-token prefill launches it 0 times;
               ``launch.serve.main`` at its defaults (batch 4, 32 tokens,
               max-seq 128) launches no kernel; tokens/s, ms per decode
               step, the decode loop's device idle share, peak memory
  serve_ssm    the same for mamba2-780m at full width (48 x 1536, bf16,
               780,148,992 seeded parameters): the 4 x 4,096 prefill
               calls the SSD scan kernel once per layer (bf16: the
               tensor-core route, four CUDA launches per call; f32: the
               f32-core one, three) and agrees with ``force="torch"``;
               decode runs no kernel

Then a ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and no result line is printed.  Without a CUDA device
the script exits non-zero before doing anything.

``--only PHASE,...`` runs ``build`` and the named phases alone, for
debugging on the card, and prints no result lines.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM published rates: HBM bytes/s, non-tensor-core float32
#: operations/s and dense bf16 tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
BIG = 1e30
CAMPAIGN_KS = (0.0, 0.05, 0.1, 0.2, 0.3)
CAMPAIGN_SEEDS = (0, 1, 2, 3)
CAMPAIGN_J = 10_000


#: a file that also takes every line ``emit`` prints (``--log``)
LOG = []


def emit(phase: str, **fields) -> None:
    line = json.dumps({"phase": phase, **fields})
    print(line, flush=True)
    for path in LOG:
        with open(path, "a") as f:
            f.write(line + "\n")


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


def host_us(fn, iters: int, warmup: int = 3) -> float:
    """Mean host microseconds per call of ``fn`` over ``iters`` calls with
    no synchronisation between them: the enqueue cost alone (the device
    finishes after the clock stops)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e6


@functools.cache
def launch_floor() -> dict:
    """The least a launch costs in this process: per-call (CUDA events over
    back-to-back calls), host and device µs of a 1-element elementwise op,
    ``x.add_(1)`` on ``x = torch.ones(1, device="cuda")``."""
    import torch
    x = torch.ones(1, device="cuda")
    fn = lambda: x.add_(1)  # noqa: E731
    return dict(launch_floor_us=cuda_ms(fn, 2000) * 1e3,
                launch_floor_host_us=host_us(fn, 2000),
                launch_floor_device_us=_device_us_per_call(
                    fn, ("elementwise_kernel",)))


def _device_us_by_kernel(fn, names, iters: int = 200) -> dict:
    """Device time (µs) per call of ``fn`` in each CUDA kernel (or memset)
    whose name contains one of ``names``, by the kernel's own name, from
    a profiler trace of ``iters`` calls: the kernels alone, without the
    host's launch gaps that the back-to-back event timing includes.  Each
    is the mean time of the kernel's traced launches times its launches
    per call (traced launches / iters, rounded, at least 1), so that
    launches the trace drops do not count as time not spent."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total: dict = {}
    count: dict = {}
    pattern = re.compile("(" + "|".join(map(re.escape, names)) + r")\w*")
    for e in prof.events():
        match = pattern.search(e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA and match:
            name = match.group(0)
            total[name] = total.get(name, 0.0) + e.device_time_total
            count[name] = count.get(name, 0) + 1
    return {name: total[name] / count[name]
            * max(1, round(count[name] / iters)) for name in total}


def _device_us_per_call(fn, names, iters: int = 200):
    """The sum of ``_device_us_by_kernel``: device µs per call of ``fn``
    in the kernels named; None if the trace is empty."""
    by_kernel = _device_us_by_kernel(fn, names, iters)
    return sum(by_kernel.values()) if by_kernel else None


def _device_busy_us(fn, count=False):
    """Device time (µs) of every CUDA kernel, memset and copy one call of
    ``fn`` makes, from a profiler trace (None if the trace is empty);
    with ``count``, also the number of those device operations."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = [e.device_time_total for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(times) if times else None
    return (busy, len(times)) if count else busy


def _bound(bytes_moved: float, ops: float,
           ops_per_s: float = VECTOR_OPS_PER_S) -> dict:
    """The least time for the work: bytes over the HBM rate against
    operations over ``ops_per_s`` (the f32 vector rate unless given),
    whichever is larger."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=bytes_moved, ops=ops)


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
         ptxas={k: [ln for ln in v["log"].splitlines()
                    if "Used" in ln or "spill" in ln]
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
    cases["recheck"] = _kth_case((20, 17, 136), 5, dev)      # EASY guard
    cases["rows"] = _kth_case((4, 17, 136), 6, dev)          # cons. rows
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

    def timings(free, nreq):
        """Kernel, host, device, twin and sort+gather times and the bound
        of one shape: each input byte read once, each output written once;
        32 compare-and-count passes over every key (the radix select's
        work: fewer than the rank kernel's n compares per key)."""
        n, rows = free.shape[-1], nreq.numel()
        idx = (nreq.long() - 1).clamp(0, n - 1).unsqueeze(-1)
        t = dict(
            kernel_us=cuda_ms(lambda: kth_free_cuda(free, nreq), 2000) * 1e3,
            host_us=host_us(lambda: kth_free_cuda(free, nreq), 2000),
            kernel_device_us=_device_us_per_call(
                lambda: kth_free_cuda(free, nreq),
                ("kth_free_rank", "kth_free_smem")),
            plain_us=cuda_ms(lambda: radix_select_kth(free, nreq), 50) * 1e3,
            library_us=cuda_ms(lambda: torch.sort(free, -1).values.gather(
                -1, idx), 500) * 1e3)
        t.update(_bound(free.numel() * 4 + rows * 8, 32 * free.numel() * 2))
        return t

    # the campaign step's shape; the EASY step's two: its window scored
    # against one table (the batched entry) and the head recheck (one
    # request per trial row)
    free, nreq = cases["slice"]
    res = dict(shape=list(free.shape), **timings(free, nreq),
               library="torch.sort + gather (two calls)",
               easy_shape=list(cases["easy"][0].shape),
               easy={k: v for k, v in timings(*cases["easy"]).items()
                     if k not in ("bytes", "ops")},
               recheck_shape=list(cases["recheck"][0].shape),
               recheck={k: v for k, v in timings(*cases["recheck"]).items()
                        if k not in ("bytes", "ops")},
               rows_shape=list(cases["rows"][0].shape),
               rows={k: v for k, v in timings(*cases["rows"]).items()
                     if k not in ("bytes", "ops")},
               max_abs_err=max_err, cases=sorted(cases),
               launches_so_far=kth_free_cuda.launches, **launch_floor())
    emit("kernel", name="kth_free", **res)
    return res


def _pairs(n, gen, dev):
    import torch
    return torch.rand((2, n), generator=gen, device=dev) * 2 - 1


def phase_kernel_ep() -> dict:
    """The CUDA EP kernel against its plain version: the workload's draw
    pass [16, 2, 2^16] into a non-zero carry (and against 16 per-batch
    calls added into the same carry), ragged passes, a pass of more
    batches than one finish step, the per-batch call [2, 2^16], a wide
    [2, 2^22] call and edge pairs."""
    import torch
    from repro_torch.kernels.ep import (ep_pairs_cuda, ep_pairs_ref,
                                        ep_pass_cuda, ep_pass_ref)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    edges = torch.tensor(
        [[0.0, 1.0, -1.0, 0.0, 1.0, -1.0, 0.6, -0.6, 0.5, 1e-20, 2.0 ** -22,
          -0.0, float(torch.nextafter(torch.tensor(1.0), torch.tensor(0.0)))],
         [0.0, 0.0, 0.0, -1.0, 1.0, -1.0, 0.8, -0.8, 0.5, 0.0, 0.0, -0.0,
          0.0]], device=dev)
    cases = {"batch": _pairs(2 ** 16, gen, dev),
             "wide": _pairs(2 ** 22, gen, dev), "edges": edges}
    max_err, sums_equal = 0.0, True

    def compare(name, got, want):
        nonlocal max_err, sums_equal
        (h, s), (h2, s2) = got, want
        check(torch.equal(h, h2), f"ep kernel hist != plain ({name})")
        check(bool(torch.isclose(s, s2, rtol=1e-6, atol=0.0,
                                 equal_nan=True).all()),
              f"ep kernel sums beyond rtol 1e-6 of plain ({name}): "
              f"{s.tolist()} {s2.tolist()}")
        sums_equal &= bool(((s == s2) | (s.isnan() & s2.isnan())).all())
        if bool(torch.isfinite(s2).all()):
            max_err = max(max_err, float((s - s2).abs().max()))

    for name, u in cases.items():
        got = ep_pairs_cuda(u)
        torch.cuda.synchronize()
        compare(name, got, ep_pairs_ref(u))
    check(float(ep_pairs_cuda(edges)[0].sum()) == 9.0,
          "ep edge pairs: 9 of 13 accepted (t == 0 and t > 1 rejected)")

    # the draw pass of the class A run, into a carry whose counts are past
    # 2^24 (so the f32 adds round); ragged passes (n not a multiple of 4:
    # scalar loads, one pair a thread, below and above 2^20 pairs); more
    # batches than one finish step holds
    passes = {name: torch.rand(shape, generator=gen, device=dev) * 2 - 1
              for name, shape in (("draw_pass", (16, 2, 2 ** 16)),
                                  ("ragged_pass", (5, 2, 1001)),
                                  ("ragged_wide_pass", (16, 2, 65539)),
                                  ("many_batches_pass", (40, 2, 4096)))}
    draw = passes["draw_pass"]
    hist0 = torch.arange(10, device=dev, dtype=torch.float32) * 1e6 + 2 ** 24
    sums0 = torch.tensor([123.25, -4567.5], device=dev)
    for name, u in passes.items():
        got = ep_pass_cuda(u, hist0.clone(), sums0.clone())
        torch.cuda.synchronize()
        compare(name, got, ep_pass_ref(u, hist0.clone(), sums0.clone()))
    # one pass == its batches one call each, added into the carry in order
    h, s = hist0.clone(), sums0.clone()
    for ub in draw:
        hb, sb = ep_pairs_cuda(ub)
        h, s = h + hb, s + sb
    compare("pass_vs_batches", ep_pass_cuda(draw, hist0.clone(),
                                            sums0.clone()), (h, s))

    def timings(fn, plain):
        by_kernel = _device_us_by_kernel(fn, ("ep_partial", "ep_finish"))
        return dict(kernel_us=cuda_ms(fn, 2000) * 1e3,
                    host_us=host_us(fn, 2000),
                    kernel_device_us=(sum(by_kernel.values()) if by_kernel
                                      else None),
                    device_us_by_kernel=by_kernel,
                    plain_us=cuda_ms(plain, 20) * 1e3)

    hist, sums = hist0.clone(), sums0.clone()
    nb, n = draw.shape[0], draw.shape[2]
    res = dict(shape=list(draw.shape),
               **timings(lambda: ep_pass_cuda(draw, hist, sums),
                         lambda: ep_pass_ref(draw, hist, sums)),
               library_us=None, library=None)
    # per pair: 2 muls, 1 add, 2 compares, log, mul, div, sqrt, 2 muls,
    # 2 abs, max, convert, clip, count, 2 adds = 20 operations; 8 bytes
    # read; the 12 f32 carries read and written
    res.update(_bound(8 * nb * n + 96, 20 * nb * n))
    u = cases["batch"]
    batch = dict(shape=list(u.shape),
                 **timings(lambda: ep_pairs_cuda(u), lambda: ep_pairs_ref(u)),
                 **{k: v for k, v in _bound(8 * n + 48, 20 * n).items()
                    if k in ("bound_ms", "bound_by")})
    res.update(batch=batch, wide_shape=list(cases["wide"].shape),
               wide_kernel_us=cuda_ms(lambda: ep_pairs_cuda(cases["wide"]),
                                      200) * 1e3,
               max_abs_err=max_err, sums_equal=sums_equal,
               cases=sorted(cases) + sorted(passes) + ["pass_vs_batches"],
               **launch_floor())
    emit("kernel", name="ep", **res)
    return res


def _host_steps(fn, module, alloc) -> dict:
    """Host µs per call of a kernel wrapper ``fn`` and of its steps, each
    over 2,000 calls with no synchronisation: ``whole``; ``no_launch``,
    the wrapper with ``module._build.launch`` stubbed to return 0 (its
    checks, allocation and Python calls, without the C entry);
    ``launch_plumbing``, ``_build.launch`` with a C-free callback (the
    device check and the raw stream); ``alloc``, the wrapper's output
    allocation alone.  ``c_entry_and_launch``, what is left of ``whole``,
    is the ctypes call and the CUDA API calls of the C entry."""
    import torch
    build = module._build
    launch = build.launch
    dev = torch.cuda.current_device()
    steps = dict(whole=host_us(fn, 2000))
    build.launch = lambda device, call: 0
    try:
        steps["no_launch"] = host_us(fn, 2000)
    finally:
        build.launch = launch
    steps["launch_plumbing"] = host_us(lambda: launch(dev, lambda s: 0), 2000)
    steps["alloc"] = host_us(alloc, 2000)
    steps["c_entry_and_launch"] = (steps["whole"] - steps["no_launch"]
                                   - steps["launch_plumbing"])
    return steps


def phase_kernel_is() -> dict:
    """The CUDA histogram kernel against its plain version: IS class A
    (2^23 keys, 1,024 buckets, shift 16), out-of-range keys, a bucket
    count above shared memory (the kernel's global-atomic path) and one
    just above it, ragged inputs (keys[1:], not 16-byte aligned;
    keys[:1001]; 3 keys; 1,000 keys) and 2^24 + 3 keys (uint32 counts and
    a conversion launch)."""
    import torch
    from repro_torch.kernels.is_hist import (SMEM_BUCKETS, key_histogram_cuda,
                                             key_histogram_ref)
    from repro_torch.kernels.is_hist import kernel as is_kernel
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    n, nb, shift = 2 ** 23, 1024, 16
    keys = torch.randint(0, nb << shift, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    wild = keys.clone()
    wild[: n // 8] = torch.randint(-2 ** 31, 0, (n // 8,), generator=gen,
                                   device=dev, dtype=torch.int32)
    wild[n // 8: n // 4] = torch.randint(nb << shift, 2 ** 31 - 1, (n // 8,),
                                         generator=gen, device=dev,
                                         dtype=torch.int32)
    big_nb = 2 * SMEM_BUCKETS
    cases = {"class_A": (keys, nb, shift), "out_of_range": (wild, nb, shift),
             "global_atomics": (torch.randint(-5, big_nb + 5, (2 ** 22,),
                                              generator=gen, device=dev,
                                              dtype=torch.int32), big_nb, 0),
             "smem_buckets_plus_1": (wild[: 2 ** 20], SMEM_BUCKETS + 1, 12),
             "few_keys": (keys[:1000], 16, 26),
             "unaligned": (wild[1:], nb, shift),
             "keys_1001": (wild[:1001], nb, shift),
             "keys_3": (keys[:3], nb, shift),
             "keys_3_unaligned": (keys[5:8], nb, shift),
             "keys_2_24_plus_3": (torch.randint(
                 0, nb << shift, (2 ** 24 + 3,), generator=gen, device=dev,
                 dtype=torch.int32), nb, shift)}
    check(wild[1:].data_ptr() % 16 != 0, "keys[1:] is not 16-byte aligned")
    for name, (k, b, sh) in cases.items():
        out = key_histogram_cuda(k, n_buckets=b, bucket_shift=sh)
        torch.cuda.synchronize()
        check(torch.equal(out, key_histogram_ref(k, n_buckets=b,
                                                 bucket_shift=sh)),
              f"is_hist kernel != plain ({name})")
    check(float(key_histogram_cuda(wild, n_buckets=nb,
                                   bucket_shift=shift).sum()) == n - n // 4,
          "is_hist drops every out-of-range key")
    fn = lambda: key_histogram_cuda(keys, n_buckets=nb, bucket_shift=shift)  # noqa: E731
    res = dict(n=n, n_buckets=nb, shift=shift,
               kernel_us=cuda_ms(fn, 2000) * 1e3,
               host_us_by_step=_host_steps(
                   fn, is_kernel, lambda: keys.new_empty(
                       nb, dtype=torch.float32)))
    # the memset, the count and (from 2^24 keys on) the uint32 -> f32
    # conversion
    by_kernel = _device_us_by_kernel(
        fn, ("key_hist", "counts_to_f32", "Memset"))
    res.update(kernel_device_us=(sum(by_kernel.values()) if by_kernel
                                 else None),
               device_us_by_kernel=by_kernel,
               plain_us=cuda_ms(lambda: key_histogram_ref(
                   keys, n_buckets=nb, bucket_shift=shift), 50) * 1e3,
               library_us=cuda_ms(lambda: torch.bincount(
                   keys >> shift, minlength=nb), 50) * 1e3,
               library="torch.bincount(keys >> shift, minlength=n_buckets)",
               global_kernel_us=cuda_ms(lambda: key_histogram_cuda(
                   cases["global_atomics"][0], n_buckets=big_nb,
                   bucket_shift=0), 50) * 1e3,
               max_abs_err=0.0, cases=sorted(cases), **launch_floor())
    res["host_us"] = res["host_us_by_step"]["whole"]
    # per key: shift, 2 compares, 1 atomic add; 4 bytes read; n_buckets
    # f32 written
    res.update(_bound(4 * n + 4 * nb, 4 * n))
    emit("kernel", name="is_hist", **res)
    return res


def phase_kernel_stencil() -> dict:
    """The CUDA stencil against its plain version at the CFD grids (24^3
    smoke, 64^3 class A), non-cubic grids whose y and z edges cut through
    the kernel's tiles (48x8x8, 5x7x33, 64x1x64, 3x64x5, 1x1x1), 256^3 for
    bandwidth, other coefficients, and the Dirichlet check of the
    reference's tests."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.stencil3d import kernel as st_kernel
    from repro_torch.kernels.stencil3d import stencil7_cuda, stencil7_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    grids = {s: torch.randn(s, generator=gen, device=dev)
             for s in ((24, 24, 24), (64, 64, 64), (48, 8, 8), (5, 7, 33),
                       (1, 1, 1), (64, 1, 64), (3, 64, 5), (256, 256, 256))}
    for shape, u in grids.items():
        for cc, cn in ((-6.0, 1.0), (0.3, -0.7)):
            out = stencil7_cuda(u, coef_c=cc, coef_n=cn)
            torch.cuda.synchronize()
            check(torch.equal(out, stencil7_ref(u, coef_c=cc, coef_n=cn)),
                  f"stencil7 kernel != plain {shape} ({cc}, {cn})")
    ones = stencil7_cuda(torch.ones((16, 8, 8), device=dev))
    check(float(ones[8, 4, 4]) == 0.0 and float(ones[0, 0, 0]) == -3.0,
          "stencil7 boundary is Dirichlet zero (interior 0, corner -3)")
    u = grids[(64, 64, 64)]
    w = torch.zeros((1, 1, 3, 3, 3), device=dev)
    w[0, 0, 1, 1, 1] = -6.0
    for i, j, k in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                    (1, 1, 2)):
        w[0, 0, i, j, k] = 1.0
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False     # full f32, as the kernel
    try:
        conv = lambda: F.conv3d(u[None, None], w, padding=1)  # noqa: E731
        check(bool((conv()[0, 0] - stencil7_cuda(u)).abs().max() < 1e-4),
              "conv3d yardstick computes the stencil")
        library_us = cuda_ms(conv, 500) * 1e3
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32
    big = grids[(256, 256, 256)]
    pts = u.numel()
    steps = _host_steps(lambda: stencil7_cuda(u), st_kernel,
                        lambda: torch.empty_like(u))
    res = dict(shape=list(u.shape),
               kernel_us=cuda_ms(lambda: stencil7_cuda(u), 2000) * 1e3,
               host_us=steps["whole"], host_us_by_step=steps,
               kernel_device_us=_device_us_per_call(
                   lambda: stencil7_cuda(u), ("stencil7",)),
               plain_us=cuda_ms(lambda: stencil7_ref(u), 200) * 1e3,
               library_us=library_us,
               library="F.conv3d, 7-point 3x3x3 weight, padding=1, no TF32",
               big_shape=list(big.shape),
               big_kernel_us=cuda_ms(lambda: stencil7_cuda(big), 100) * 1e3,
               big_bound_us=_bound(8 * big.numel(), 8 * big.numel())[
                   "bound_ms"] * 1e3,
               max_abs_err=0.0,
               cases=[list(s) for s in grids] + ["coefs", "dirichlet"],
               **launch_floor())
    # per point: 6 adds, 2 muls (the reference's flop count says 13 with
    # the neighbour loads); 4 bytes read and 4 written
    res.update(_bound(8 * pts, 8 * pts))
    emit("kernel", name="stencil7", **res)
    return res


def phase_kernel_host(rounds: int = 15, iters: int = 100) -> dict:
    """Host enqueue µs per call of the launch floor and of the wrappers of
    the small kernels at their path shapes, in turns: each round times
    every one of them (``iters`` calls with no synchronisation, then a
    synchronise), in an order rotated from round to round, so that the
    medians compare them free of the drift between phases.  ``iters`` is
    small enough that is_hist, whose device time exceeds its host time,
    never fills the launch queue."""
    import statistics
    import torch
    from repro_torch.kernels.is_hist import key_histogram_cuda
    from repro_torch.kernels.kth_free import kth_free_cuda
    from repro_torch.kernels.stencil3d import stencil7_cuda
    dev = torch.device("cuda")
    free, nreq = _kth_case((20, 4, 136), 0, dev)
    keys = torch.randint(0, 1 << 26, (2 ** 23,), device=dev,
                         dtype=torch.int32)
    u = torch.randn((64, 64, 64), device=dev)
    x = torch.ones(1, device=dev)
    fns = {"launch_floor": lambda: x.add_(1),
           "kth_free": lambda: kth_free_cuda(free, nreq),
           "is_hist": lambda: key_histogram_cuda(keys, n_buckets=1024,
                                                 bucket_shift=16),
           "stencil7": lambda: stencil7_cuda(u)}
    names = list(fns)
    times: dict = {k: [] for k in names}
    for r in range(rounds):
        for k in names[r % len(names):] + names[:r % len(names)]:
            times[k].append(host_us(fns[k], iters))
    res = dict(median_host_us={k: statistics.median(v)
                               for k, v in times.items()},
               range_host_us={k: [min(v), max(v)] for k, v in times.items()},
               rounds=rounds, iters=iters)
    emit("kernel_host", **res)
    return res


def phase_kernels() -> dict:
    """The ``kernel`` phase: one line per small kernel, then their host
    costs in turns."""
    res = {"kth_free": phase_kernel(), "ep": phase_kernel_ep(),
           "is_hist": phase_kernel_is(), "stencil7": phase_kernel_stencil()}
    phase_kernel_host()
    return res


#: the serving path's attention shape: b, sq, sk, h, kv, hd (tinyllama
#: prefill of 4 x 4,096 tokens)
FLASH_PATH = (4, 4096, 4096, 32, 4, 64)
#: the reference's kernel test shapes (tests/test_kernels.py) plus head
#: dim 256 and a ragged rectangle: b, sq, sk, h, kv, hd
FLASH_CASES = ((2, 256, 256, 8, 2, 64), (1, 256, 256, 4, 4, 128),
               (2, 128, 384, 4, 1, 64), (1, 512, 512, 2, 2, 32),
               (1, 256, 256, 4, 2, 64), (1, 256, 256, 4, 4, 256),
               (1, 100, 70, 4, 2, 64))
FLASH_ATOL = {"float32": 3e-5, "bfloat16": 3e-2}


def _flash_inputs(shape, dtype, gen):
    import torch
    b, sq, sk, h, kv, hd = shape
    dev = torch.device("cuda")
    return tuple(torch.randn(s, generator=gen, device=dev).to(dtype)
                 for s in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd)))


def _bf16_ulps(out, ref):
    """Worst |out - ref| over an elementwise bound of 2 bf16 ulps of |ref|
    plus 1e-4 (both sides f32 inside, each rounded once to bf16, so they
    may land one ulp apart), and that bound's median over the median
    |ref|."""
    import torch
    a = ref.float().abs()
    _, e = torch.frexp(a)                  # |ref| in [2^(e-1), 2^e)
    bound = torch.where(a > 0, torch.ldexp(torch.ones_like(a), e - 7),
                        torch.zeros_like(a)) + 1e-4
    worst = float(((out.float() - ref.float()).abs() / bound).max())
    return worst, float(bound.median() / a.median())


def _attention_work(shape, causal, itemsize):
    """(bytes, operations) of one attention call: q, k, v read once and
    the output written once; 4 hd operations per (query, key) pair the
    mask keeps (the two products)."""
    b, sq, sk, h, kv, hd = shape
    pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal
             else sq * sk)
    return (itemsize * b * hd * (2 * sq * h + 2 * sk * kv),
            4 * hd * b * h * pairs)


def _flash_issued(shape, causal):
    """Operations the tensor-core route issues: for each 64-row tile of
    (position, query head) rows of one (batch, KV head), 64-key tiles up
    to the tile's last position (causal) or to sk, each pair costing
    2 hd (S = Q K^T) + 4 hd (P V with P split in two) operations."""
    b, sq, sk, h, kv, hd = shape
    rep, rows = h // kv, sq * h // kv
    keys = 0
    for row0 in range(0, rows, 64):
        end = min(sk, (min(row0 + 64, rows) - 1) // rep + 1) if causal else sk
        keys += -(-end // 64) * 64
    return 6 * hd * 64 * keys * b * kv


def _sdpa(q, k, v, causal):
    """The library yardstick: ``F.scaled_dot_product_attention`` on its
    flash backend, in its own [b, h, s, hd] layout (the port never calls
    it)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def call():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal,
                                                  enable_gqa=True)
    return call


def phase_kernel_flash() -> dict:
    """The CUDA flash attention kernel against its blocked plain version
    and the plain-softmax oracle, in f32 and bf16.  bf16 outputs are also
    held to 2 bf16 ulps of |ref| (``_bf16_ulps``), which is far tighter
    than atol 3e-2 where |ref| is small (late causal rows)."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention,
                                                     flash_attention_cuda,
                                                     plain_attention)
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = []

    def compare(shape, dtype, causal, block, qkv=None):
        q, k, v = qkv or _flash_inputs(shape, dtype, gen)
        out = flash_attention_cuda(q, k, v, causal=causal)
        route = flash_attention_cuda.last_route
        torch.cuda.synchronize()
        plain = flash_attention(q, k, v, causal=causal, block_q=block,
                                block_k=block, force="torch")
        ref = attention_ref(q, k, v, causal=causal)
        e_plain = float((out.float() - plain.float()).abs().max())
        e_ref = float((out.float() - ref.float()).abs().max())
        name = str(dtype).split(".")[-1]
        row = dict(shape=list(shape), dtype=name, causal=causal,
                   strided=qkv is not None, route=route, vs_plain=e_plain,
                   vs_ref=e_ref)
        check(out.dtype == dtype and out.shape == q.shape,
              f"flash kernel output {out.dtype} {tuple(out.shape)}")
        check(e_plain <= FLASH_ATOL[name] and e_ref <= FLASH_ATOL[name],
              f"flash kernel beyond atol {FLASH_ATOL[name]} at {shape} "
              f"{name} causal={causal}: {e_plain} vs plain, {e_ref} vs ref")
        if dtype == torch.bfloat16:
            u_ref, ratio = _bf16_ulps(out, ref)
            ulps = max(_bf16_ulps(out, plain)[0], u_ref)
            row.update(ulp_bound_used=ulps, ulp_bound_over_median_ref=ratio,
                       median_abs_ref=float(ref.float().abs().median()))
            check(ulps <= 1.0, f"flash kernel beyond 2 bf16 ulps of |ref| "
                  f"+ 1e-4 at {shape} causal={causal}: {ulps} of the bound")
        errs.append(row)
        return q, k, v, out, e_plain

    for shape in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                compare(shape, dtype, causal, 128)
    # q, k, v read in place through their strides: views of one fused
    # [b, s, h + 2 kv, hd] projection, and head-major [b, h, s, hd]
    # tensors seen as [b, s, h, hd]; equal bit for bit to the kernel on
    # contiguous copies (f32: the f32-core route, bf16: the tensor-core one)
    b, s, _, h, kv, hd = shape = (2, 512, 512, 8, 2, 64)
    for dtype in (torch.float32, torch.bfloat16):
        fused = torch.randn((b, s, h + 2 * kv, hd), generator=gen,
                            device="cuda").to(dtype)
        views = {"fused": (fused[:, :, :h], fused[:, :, h:h + kv],
                           fused[:, :, h + kv:]),
                 "head_major": tuple(
                     torch.randn((b, n, s, hd), generator=gen,
                                 device="cuda").to(dtype).transpose(1, 2)
                     for n in (h, kv, kv))}
        for layout, qkv in views.items():
            check(not any(t.is_contiguous() for t in qkv), f"{layout} views")
            for causal in (True, False):
                out = compare(shape, dtype, causal, 128, qkv)[3]
                copy = flash_attention_cuda(*(t.contiguous() for t in qkv),
                                            causal=causal)
                check(torch.equal(out, copy), f"flash kernel on {layout} "
                      f"{dtype} views differs from its run on contiguous "
                      f"copies")
        del fused, views
    compare(FLASH_PATH, torch.float32, True, 512)
    check(flash_attention_cuda.last_route == "f32-core",
          "f32 inputs take the f32-core kernel")
    q, k, v, out, path_err = compare(FLASH_PATH, torch.bfloat16, True, 512)
    route = flash_attention_cuda.last_route
    check(route == "tensor-core", f"bf16 path inputs took the {route} "
          f"kernel, not the tensor-core one")

    fn = lambda: flash_attention_cuda(q, k, v, causal=True)  # noqa: E731
    lib = _sdpa(q, k, v, True)
    lib_err = float((lib().transpose(1, 2).float() - out.float()).abs().max())
    check(lib_err <= FLASH_ATOL["bfloat16"],
          f"the SDPA yardstick computes the same attention ({lib_err})")
    nbytes, ops = _attention_work(FLASH_PATH, True, 2)
    res = dict(shape=dict(q=list(q.shape), k=list(k.shape), dtype="bfloat16",
                          causal=True),
               route=route,
               issued_floor_ms=_flash_issued(FLASH_PATH, True)
               / BF16_TENSOR_OPS_PER_S * 1e3,
               kernel_us=cuda_ms(fn, 20) * 1e3,
               host_us=host_us(fn, 30),
               kernel_device_us=_device_us_per_call(fn, ("flash_fwd",), 10),
               plain_us=cuda_ms(lambda: flash_attention(
                   q, k, v, causal=True, block_q=512, block_k=512,
                   force="torch"), 3, warmup=1) * 1e3,
               library_us=cuda_ms(lib, 20) * 1e3,
               library="F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True), flash backend, [b, h, s, hd]",
               library_max_abs_diff=lib_err,
               max_abs_err=path_err, cases=errs)
    res.update(_bound(nbytes, ops, BF16_TENSOR_OPS_PER_S))
    del q, k, v, out

    # one sequence of the reference's prefill_32k shape
    long = (1, 32768, 32768, 32, 4, 64)
    q, k, v = _flash_inputs(long, torch.bfloat16, gen)
    fn = lambda: flash_attention_cuda(q, k, v, causal=True)  # noqa: E731
    out = fn()
    tail = torch.arange(32768 - 64, 32768, device=q.device)
    last = plain_attention(q[:, -64:], k, v, causal=True, q_positions=tail)
    long_err = float((out[:, -64:].float() - last.float()).abs().max())
    long_ulps, long_ratio = _bf16_ulps(out[:, -64:], last)
    check(long_err <= FLASH_ATOL["bfloat16"] and long_ulps <= 1.0,
          f"flash kernel at s = 32,768: last rows off by {long_err}, "
          f"{long_ulps} of 2 bf16 ulps of |ref| + 1e-4")
    nbytes, ops = _attention_work(long, True, 2)
    res["long"] = dict(shape=list(long), route=flash_attention_cuda.last_route,
                       kernel_us=cuda_ms(fn, 2, 1) * 1e3,
                       library_us=cuda_ms(_sdpa(q, k, v, True), 3, 1) * 1e3,
                       last_rows_max_abs_err=long_err,
                       last_rows_ulp_bound_used=long_ulps,
                       last_rows_ulp_bound_over_median_ref=long_ratio,
                       last_rows_median_abs_ref=float(
                           last.float().abs().median()),
                       bound_us=_bound(nbytes, ops, BF16_TENSOR_OPS_PER_S)[
                           "bound_ms"] * 1e3)
    emit("kernel", name="flash_attention", **res)
    return res


#: the mamba2-780m prefill's scan: b, l, h, g, p, n, chunk (x [4, 4096,
#: 48, 64] seen as 192 head rows, B/C [4, 4096, 1, 128], 16 chunks)
SSD_PATH = (4, 4096, 48, 1, 64, 128, 256)
#: the reference's kernel test shapes (tests/test_kernels.py): bh, l, p,
#: n, rep, chunk
SSD_CASES = ((4, 128, 16, 8, 2, 32), (2, 64, 8, 16, 1, 16),
             (6, 96, 32, 8, 3, 32))
#: the reference's kernel contract (atol) and, at the path's magnitudes,
#: a band relative to max |plain|: |cum| grows to 256 x mean |dA| over a
#: chunk (an f32 ulp of 1.5e-5 from 128 up), so the two summation orders
#: of the cumsum move exp(cum_i - cum_j) by a few 1e-5 of itself
SSD_ATOL = 2e-4
SSD_REL = 1e-4


def _ssd_inputs(shape, dtype, gen):
    """Model-layout scan inputs as the mamba prefill makes them: x, B, C
    views of one [b, l, h p + 2 g n] tensor of silu'd unit normals in
    ``dtype``; dt = softplus(unit normal) [b, l, h] f32; dA = dt * A with
    A = -exp(0.3 unit normal) per head."""
    import torch
    import torch.nn.functional as F
    b, l, h, g, p, n, _ = shape
    xbc = F.silu(torch.randn((b, l, h * p + 2 * g * n), generator=gen,
                             device="cuda")).to(dtype)
    x = xbc[..., :h * p].reshape(b, l, h, p)
    B = xbc[..., h * p:h * p + g * n].reshape(b, l, g, n)
    C = xbc[..., h * p + g * n:].reshape(b, l, g, n)
    dt = F.softplus(torch.randn((b, l, h), generator=gen, device="cuda"))
    A = -torch.exp(0.3 * torch.randn(h, generator=gen, device="cuda"))
    return x, dt, dt * A, B, C


def _ssd_work(shape, itemsize):
    """(bytes, operations) of one scan: x, dt, dA, B, C read once, y and
    the state written once; per (head row, chunk) 2 (n + p) operations for
    each of the Q (Q + 1) / 2 pairs j <= i (C.B and the weighted sum of
    x) and 2 Q n p each for the off-diagonal term and the chunk state."""
    b, l, h, g, p, n, q = shape
    rows, nc = b * h, l // q
    ops = rows * nc * (q * (q + 1) * (n + p) + 4 * q * n * p)
    nbytes = (itemsize * (b * l * h * p + 2 * b * l * g * n)
              + 4 * (2 * b * l * h + b * l * h * p + rows * p * n))
    return nbytes, ops


def _ssd_issued(shape):
    """Operations the tensor-core route issues, from its tiling (64 x 64
    output tiles, operands zero-padded to multiples of 64, each split
    operand doubling its product): C.B once per (batch, group, chunk) on
    the tiles j0 <= i0; per (head row, chunk) the state x^T (B w) in
    64 x 128 tiles and, per 64-row query tile, y_off and the y_diag tiles
    j0 <= i0."""
    b, l, h, g, p, n, q = shape
    nc, rows = l // q, b * h
    up = lambda v, t: -(-v // t) * t  # noqa: E731
    qt, pp, nn = up(q, 64) // 64, up(p, 64), up(n, 64)
    tile = 2 * 64 * 64 * 64                # one 64 x 64 x 64 product
    cb = b * g * nc * qt * (qt + 1) // 2 * 2 * 64 * 64 * nn
    state = rows * nc * 2 * 2 * pp * up(n, 128) * up(q, 64)
    out = rows * nc * (pp // 64) * 2 * tile * (
        qt * (nn // 64) + qt * (qt + 1) // 2)
    return cb + state + out


def _ssd_check(name, y, s, py, ps, rel):
    """|kernel - plain| of y and the state within SSD_ATOL (+ ``rel`` *
    max |plain|); returns the row with the share of the band used."""
    import torch
    row = {}
    for what, a, b in (("y", y, py), ("state", s, ps)):
        err = float((a - b).abs().max())
        top = float(b.abs().max())
        band = SSD_ATOL + rel * top
        check(bool(torch.isfinite(a).all()), f"ssd kernel {what} not "
              f"finite ({name})")
        check(err <= band, f"ssd kernel {what} beyond {band} of the plain "
              f"version ({name}): {err} (max |plain| {top})")
        row.update({f"{what}_max_abs_err": err, f"{what}_max_abs": top,
                    f"{what}_band": band, f"{what}_band_used": err / band})
    return row


def phase_kernel_ssd() -> dict:
    """The CUDA SSD scan against its plain version: the reference's test
    shapes (flat layout, atol 2e-4, f32 and bf16), its chunk-invariance
    case, the mamba2-780m path shape in bf16 and f32 (model-layout views,
    band SSD_ATOL + SSD_REL max |plain|), those views against contiguous
    flat copies (bit for bit), and one b = 1, l = 32,768 call."""
    import torch
    from repro_torch.kernels.ssd_scan import (ssd_chunked_dA, ssd_scan_cuda,
                                              ssd_scan_ref)
    from repro_torch.kernels.ssd_scan.kernel import LAUNCHES_PER_CALL
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []

    def flat_inputs(bh, l, p, n, rep, decay=None):
        bg = bh // rep
        x = torch.randn((bh, l, p), generator=gen, device="cuda") * 0.5
        dt = torch.nn.functional.softplus(
            torch.randn((bh, l), generator=gen, device="cuda"))
        A = (-torch.exp(torch.randn(bh, generator=gen, device="cuda") * 0.3)
             if decay is None else torch.full((bh,), decay, device="cuda"))
        B, C = (torch.randn((bg, l, n), generator=gen, device="cuda") * 0.5
                for _ in range(2))
        return x, dt, dt * A[:, None], B, C

    for case in SSD_CASES:
        *dims, chunk = case
        x, dt, dA, B, C = flat_inputs(*dims)
        for dtype in (torch.float32, torch.bfloat16):
            xx, bb, cc = (t.to(dtype) for t in (x, B, C))
            y, s = ssd_scan_cuda(xx, dt, dA, bb, cc, chunk=chunk)
            torch.cuda.synchronize()
            py, ps = ssd_scan_ref(xx, dt, dA, bb, cc, chunk=chunk)
            rows.append(dict(case=list(case), dtype=str(dtype)[6:],
                             route=ssd_scan_cuda.last_route,
                             **_ssd_check(f"{case} {dtype}", y, s, py, ps,
                                          0.0)))
    # chunk invariance: the reference's case, chunk 16 against 64
    x, dt, dA, B, C = flat_inputs(2, 128, 8, 8, 1, decay=-0.5)
    y16, s16 = ssd_scan_cuda(x, dt, dA, B, C, chunk=16)
    y64, s64 = ssd_scan_cuda(x, dt, dA, B, C, chunk=64)
    torch.cuda.synchronize()
    rows.append(dict(case="chunk 16 vs 64", **_ssd_check(
        "chunk invariance", y16, s16, y64, s64, 0.0)))

    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        x, dt, dA, B, C = _ssd_inputs(SSD_PATH, dtype, gen)
        check(not x.is_contiguous() and not B.is_contiguous(),
              "path inputs are strided views")
        fn = lambda: ssd_scan_cuda(x, dt, dA, B, C, chunk=256)  # noqa: E731
        y, s = fn()
        route = ssd_scan_cuda.last_route
        torch.cuda.synchronize()
        check(route == ("tensor-core" if dtype == torch.bfloat16
                        else "f32-core"), f"{name} path inputs took the "
              f"{route} route")
        plain = lambda: ssd_chunked_dA(x, dt, dA, B, C, 256)  # noqa: E731
        py, ps = plain()
        row = _ssd_check(f"path {name}", y, s, py, ps, SSD_REL)
        rows.append(dict(case="path", dtype=name, route=route, **row))
        del py, ps
        # the same rows as contiguous flat copies: bit for bit
        b, l, h, g, p, n, _ = SSD_PATH
        fy, fs = ssd_scan_cuda(
            x.transpose(1, 2).reshape(b * h, l, p).contiguous(),
            dt.transpose(1, 2).reshape(b * h, l).contiguous(),
            dA.transpose(1, 2).reshape(b * h, l).contiguous(),
            B.transpose(1, 2).reshape(b * g, l, n).contiguous(),
            C.transpose(1, 2).reshape(b * g, l, n).contiguous(), chunk=256)
        check(torch.equal(fy, y.transpose(1, 2).reshape(b * h, l, p))
              and torch.equal(fs, s.reshape(b * h, p, n)),
              f"ssd kernel on model-layout views differs from its run on "
              f"contiguous flat copies ({name})")
        del fy, fs
        nbytes, ops = _ssd_work(SSD_PATH, x.element_size())
        launches = _device_us_by_kernel(fn, ("ssd_",), 10)
        res[name] = dict(
            route=route, launches_per_call=LAUNCHES_PER_CALL[route],
            kernel_us=cuda_ms(fn, 20) * 1e3, host_us=host_us(fn, 30),
            kernel_device_us=sum(launches.values()) if launches else None,
            launch_device_us=launches,
            plain_us=cuda_ms(plain, 3, warmup=1) * 1e3,
            max_abs_err=row["y_max_abs_err"], **_bound(
                nbytes, ops, BF16_TENSOR_OPS_PER_S
                if dtype == torch.bfloat16 else VECTOR_OPS_PER_S))
        del x, dt, dA, B, C, y, s

    # one sequence of the reference's prefill_32k length
    long = (1, 32768, 48, 1, 64, 128, 256)
    x, dt, dA, B, C = _ssd_inputs(long, torch.bfloat16, gen)
    fn = lambda: ssd_scan_cuda(x, dt, dA, B, C, chunk=256)  # noqa: E731
    y, s = fn()
    torch.cuda.synchronize()
    py, ps = ssd_chunked_dA(x, dt, dA, B, C, 256)
    long_row = _ssd_check("b 1, l 32,768", y, s, py, ps, SSD_REL)
    del py, ps
    nbytes, ops = _ssd_work(long, 2)
    long_row.update(shape=list(long), route=ssd_scan_cuda.last_route,
                    kernel_us=cuda_ms(fn, 3, 1) * 1e3,
                    bound_us=_bound(nbytes, ops, BF16_TENSOR_OPS_PER_S)[
                        "bound_ms"] * 1e3)
    del x, dt, dA, B, C, y, s

    res["bfloat16"]["issued_floor_ms"] = (
        _ssd_issued(SSD_PATH) / BF16_TENSOR_OPS_PER_S * 1e3)
    out = dict(res["bfloat16"], shape=dict(
        x=[SSD_PATH[0], SSD_PATH[1], SSD_PATH[2], SSD_PATH[4]],
        B=[SSD_PATH[0], SSD_PATH[1], SSD_PATH[3], SSD_PATH[5]],
        chunk=SSD_PATH[6], dtype="bfloat16", layout="model-layout views"),
        library_us=None, library=None, f32=res["float32"], long=long_row,
        cases=rows)
    emit("kernel", name="ssd_scan", **out)
    return out


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


#: the campaign's fault model (``FaultConfig`` fields)
CAMPAIGN_FAULTS = dict(straggler_prob=0.05, failure_prob=0.01)


def _campaign(w, placer=None, device=None, totals_only=False, queue=None,
              engine=None, faults=CAMPAIGN_FAULTS, policy=None,
              seeds=CAMPAIGN_SEEDS):
    """``Scheduler.run`` of the campaign's grid (``paper`` over the K grid
    x seeds, warm start) or of ``policy`` with ``seeds``."""
    from repro_torch.core import FaultConfig, Scheduler
    sched = Scheduler(policy or _policy_of(), seeds=seeds, warm_start=True,
                      faults=None if faults is None else FaultConfig(**faults),
                      placer=placer, device=device, queue=queue,
                      engine=engine)
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


def _launches_per_step(w_small, steps=None, **kw):
    """CUDA kernels launched, device µs, and the device µs and launches of
    the ten busiest kernel names, per step, from a profiler trace of a
    short run of ``steps`` steps (default: one per job); None when the
    profiler records no device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    steps = steps or len(w_small.prog)
    _campaign(w_small, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _campaign(w_small, **kw)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None, None, None
    busy_us = sum(e.device_time_total for e in kernels)
    names: dict = {}
    for e in kernels:
        us, n = names.get(e.name, (0.0, 0))
        names[e.name] = (us + e.device_time_total, n + 1)
    top = {name: {"us": us / steps, "launches": n / steps} for name, (us, n)
           in sorted(names.items(), key=lambda kv: -kv[1][0])[:10]}
    return len(kernels) / steps, busy_us / steps, top


def _count(counters: dict, kernel: str, path: str, n: int) -> None:
    """Add one main path's launches of ``kernel`` to ``counters``, and keep
    them by path."""
    counters[kernel] = counters.get(kernel, 0) + n
    counters.setdefault("by_path", {}).setdefault(kernel, {})[path] = n


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
    n_main = kth_free_cuda.launches
    _count(counters, "kth_free", "campaign", n_main)
    check(n_main == J, f"kth_free launches {n_main} != J={J}")

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
    per_step, busy_us, by_kernel = _launches_per_step(_prefix(w, 200))
    step_us = t_full / J * 1e6
    res = dict(jobs=J, lanes=B, seconds_full=t_full,
               seconds_totals_only=t_tot, seconds_twin_placer=t_twin,
               ms_per_step=t_full / J * 1e3,
               ms_per_step_totals_only=t_tot / J * 1e3,
               ms_per_step_twin_placer=t_twin / J * 1e3,
               jobs_per_s=J * B / t_full,
               jobs_per_s_totals_only=J * B / t_tot,
               kth_free_launches_per_step=n_main / J,
               cuda_launches_per_step=per_step,
               device_busy_us_per_step=busy_us,
               device_us_per_step_by_kernel=by_kernel,
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
    # EASY: the first 500 jobs of the easy_campaign stream
    w = _prefix(_easy_stream(), 500)
    for totals_only in (False, True):
        kw = dict(totals_only=totals_only, queue=EASY_QUEUE)
        cpu = _campaign(w, device="cpu", **kw)
        gpu = _campaign(w, **kw)
        banded = () if totals_only else ("total_energy", "total_wait",
                                         "slowdown_sum")
        worst = _same(cpu, gpu, EASY_FIELDS, banded, "cpu/cuda")
        emit("cross_device", queue=EASY_QUEUE, jobs=500,
             totals_only=totals_only,
             exact="all but " + ",".join(banded) if banded else "all",
             worst_rel_reduction=worst,
             n_backfilled=gpu.n_backfilled.flatten().tolist())
    # the event cores: the first EVENT_TWIN_J jobs of the event_campaign's
    # runs (a) FCFS with failure re-queue and (d) capped conservative
    banded = ("total_energy", "total_wait", "slowdown_sum")
    for run, w, kw in (
            ("fcfs_retries", _prefix(_event_stream(), EVENT_TWIN_J),
             dict(engine="events", queue=EVENT_FCFS)),
            ("cons_capped", _prefix(_cap_stream(), EVENT_TWIN_J),
             dict(policy=_cap_policy(), faults=None, seeds=0))):
        cpu = _campaign(w, device="cpu", **kw)
        gpu = _campaign(w, **kw)
        worst = _same(cpu, gpu, EVENT_FIELDS, banded, f"cpu/cuda {run}")
        emit("cross_device", run=run, jobs=EVENT_TWIN_J,
             exact="all but " + ",".join(banded),
             worst_rel_reduction=worst,
             peak_power=gpu.peak_power.flatten().tolist())


#: the EASY campaign: the reference ablation's contended SWF stream
#: (``benchmarks/scheduler_ablation.py``) at the campaign's length
EASY_WINDOW = 16
EASY_QUEUE = f"easy_backfill:window={EASY_WINDOW}"
EASY_PREFIX = 2_000
EASY_FIELDS = ("system", "tier", "nodes", "backfilled", "start", "finish",
               "wait", "energy", "runtime", "C_tab", "T_tab", "runs",
               "busy", "makespan", "max_wait", "idle_energy",
               "n_backfilled", "total_energy", "total_wait",
               "slowdown_sum")


def _easy_stream():
    """10,000 jobs of ``synthetic_swf_arrays`` through the SWF text format
    onto the four JSCC systems (maxN 136)."""
    from repro_torch.core import JSCC_SYSTEMS
    from repro_torch.data import (load_swf, swf_lines, synthetic_swf_arrays,
                                  workload_from_trace)
    return workload_from_trace(
        load_swf(swf_lines(*synthetic_swf_arrays(CAMPAIGN_J))), JSCC_SYSTEMS)


def _same(a, b, fields, banded, what) -> float:
    """Every field of two results equal, but the ``banded`` ones within
    rtol 1e-6; returns the worst relative difference of those."""
    import numpy as np
    worst = 0.0
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            check(y is None, f"{what}: {f} on one side only")
            continue
        x, y = x.cpu().numpy(), y.cpu().numpy()
        if f in banded:
            rel = np.abs(x.astype(np.float64) - y) / np.abs(x)
            worst = max(worst, float(rel.max()))
            check(bool((rel <= 1e-6).all()), f"{what} {f} rel {rel.max()}")
        else:
            check(np.array_equal(x, y, equal_nan=True),
                  f"{what}: {f} differs")
    return worst


def _totals_agree(full, tot, what, exact=("makespan", "max_wait", "C_tab",
                                          "T_tab", "runs", "n_backfilled",
                                          "peak_power", "capped_delay")):
    """``totals_only`` keeps the full path's results: the tables, peaks
    and counts exactly, Kahan sums within rtol 1e-5, busy and idle energy
    within rtol 1e-6."""
    import torch
    for f in exact:
        check(torch.equal(getattr(full, f), getattr(tot, f)),
              f"{what}: totals_only differs from full on {f}")
    for f, rtol in (("total_energy", 1e-5), ("total_wait", 1e-5),
                    ("slowdown_sum", 1e-5), ("busy", 1e-6),
                    ("idle_energy", 1e-6)):
        a, b = getattr(full, f).double(), getattr(tot, f).double()
        check(bool(((a - b).abs() <= rtol * b.abs()).all()),
              f"{what}: totals_only {f} departs from the full path")


def phase_easy_campaign(counters: dict) -> dict:
    """EASY backfilling (window 16) on the contended SWF stream, the
    campaign's grid (K x seeds = 20 lanes), stragglers and failures, warm
    start: the main path of the EASY core."""
    import numpy as np
    import torch
    from repro_torch.kernels.kth_free import kth_free_cuda
    w = _easy_stream()
    J, W, B = CAMPAIGN_J, EASY_WINDOW, len(CAMPAIGN_KS) * len(CAMPAIGN_SEEDS)
    steps = J + W

    # the main path: every count to 0 just before, read just after
    kth_free_cuda.launches = 0
    easy, t_easy, _ = _timed_campaign(w, queue=EASY_QUEUE)
    n_main = kth_free_cuda.launches
    _count(counters, "kth_free", "easy_campaign", n_main)
    check(n_main == 2 * steps,
          f"EASY kth_free launches {n_main} != 2 (J + W) = {2 * steps}")
    arrival = torch.as_tensor(w.arrival, device=easy.start.device)
    check(bool(torch.isfinite(easy.finish).all()), "finite finish times")
    check(bool((easy.start >= arrival).all()), "no job starts before it "
          "arrives")
    check(bool((easy.finish > easy.start).all()), "every job runs")
    check(bool((easy.n_backfilled > 0).all()),
          f"a lane never backfilled: {easy.n_backfilled.tolist()}")
    check(torch.equal(easy.n_backfilled,
                      easy.backfilled.sum(-1).to(torch.int32)),
          "n_backfilled != the backfilled flags")

    # FCFS on the same stream, same grid
    fcfs, t_fcfs, _ = _timed_campaign(w)
    w_easy = easy.total_wait.double().flatten().cpu()
    w_fcfs = fcfs.total_wait.double().flatten().cpu()
    worse = [i for i in range(B) if w_easy[i] > w_fcfs[i]]
    check(float(w_easy.mean()) < float(w_fcfs.mean()),
          f"EASY's mean total wait {float(w_easy.mean())} is not below "
          f"FCFS's {float(w_fcfs.mean())}")

    # the twins on a prefix: the sort placer launches nothing and equals
    # the kernel bit for bit; totals_only's running totals equal the full
    # path's (Kahan sums within rtol 1e-5, busy and idle energy, summed in
    # placement order there, within rtol 1e-6)
    wp = _prefix(w, EASY_PREFIX)
    base, t_base, n_base = _timed_campaign(wp, queue=EASY_QUEUE)
    check(n_base == 2 * (EASY_PREFIX + W), f"prefix launches {n_base}")
    srt, t_sort, n_sort = _timed_campaign(wp, queue=EASY_QUEUE,
                                          placer="sort")
    check(n_sort == 0, "placer='sort' must not launch the kernel")
    _same(base, srt, EASY_FIELDS, (), "kernel/sort")
    tot, t_tot, n_tot = _timed_campaign(wp, queue=EASY_QUEUE,
                                        totals_only=True)
    check(n_tot == 2 * (EASY_PREFIX + W), f"totals_only launches {n_tot}")
    _totals_agree(base, tot, "EASY", exact=(
        "makespan", "max_wait", "C_tab", "T_tab", "runs", "n_backfilled"))
    busy_exact = torch.equal(base.busy, tot.busy)

    # no host sync in the step: the detector sees one (.item()), and a
    # run's syncs do not grow with its length
    probe = _sync_count(lambda: torch.ones(1, device="cuda").sum().item())
    check(probe >= 1, "sync debug mode reports no sync for .item()")
    syncs = {n: _sync_count(lambda: _campaign(_prefix(w, n),
                                              queue=EASY_QUEUE))
             for n in (200, 400)}
    check(syncs[200] == syncs[400],
          f"EASY host syncs grow with J (no sync allowed in the step): "
          f"{syncs}")
    per_step, busy_us, by_kernel = _launches_per_step(
        _prefix(w, 200), steps=200 + W, queue=EASY_QUEUE)
    step_us = t_easy / steps * 1e6
    res = dict(
        jobs=J, window=W, lanes=B, steps=steps, seconds_full=t_easy,
        ms_per_step=t_easy / steps * 1e3, jobs_per_s=J * B / t_easy,
        kth_free_launches=n_main, kth_free_launches_per_step=n_main / steps,
        cuda_launches_per_step=per_step, device_busy_us_per_step=busy_us,
        device_us_per_step_by_kernel=by_kernel,
        device_idle_share=(None if busy_us is None
                           else 1.0 - busy_us / step_us),
        host_syncs_per_run=syncs, sync_probe_item=probe,
        fcfs_seconds=t_fcfs, fcfs_ms_per_step=t_fcfs / J * 1e3,
        prefix=EASY_PREFIX, prefix_seconds={"kernel": t_base,
                                            "sort": t_sort,
                                            "totals_only": t_tot},
        totals_only_busy_bit_equal=busy_exact,
        n_backfilled=easy.n_backfilled.flatten().tolist(),
        backfill_rate=easy.backfill_rate.flatten().tolist(),
        mean_backfill_rate=float(easy.backfill_rate.double().mean()),
        total_wait_easy=w_easy.tolist(), total_wait_fcfs=w_fcfs.tolist(),
        wait_change_per_lane=((w_easy - w_fcfs) / w_fcfs).tolist(),
        mean_wait_change=float(((w_easy - w_fcfs) / w_fcfs).mean()),
        lanes_where_easy_waits_longer=worse,
        total_energy=easy.total_energy.flatten().tolist(),
        total_energy_fcfs=fcfs.total_energy.flatten().tolist(),
        makespan=easy.makespan.flatten().tolist(),
        makespan_fcfs=fcfs.makespan.flatten().tolist())
    emit("easy_campaign", **res)
    return res


#: the event-granular cores: the documented campaign's stream cut to
#: EVENT_J jobs (from 10,000, for the script's time: run (a) takes 7J
#: steps and each run's twins as many again); the example's capped
#: conservative campaign (``examples/multi_cluster_campaign.py``), its
#: ``totals_only`` and uncapped twins, and ``cross_device``, on the first
#: EVENT_TWIN_J jobs
EVENT_J = 500
EVENT_TWIN_J = 500
EVENT_FCFS = f"fcfs:window={EASY_WINDOW}"
CONS_QUEUE = f"conservative:window={EASY_WINDOW}"
STRAGGLERS = dict(straggler_prob=0.05)
CAPS = (45e3, 52e3, 60e3, float("inf"))
CAP_J = 1_000
FCFS_FIELDS = ("system", "tier", "nodes", "start", "finish", "wait",
               "energy", "runtime", "total_energy", "makespan", "total_wait",
               "max_wait", "slowdown_sum", "busy", "C_tab", "T_tab", "runs",
               "idle_energy")
EVENT_FIELDS = EASY_FIELDS + ("peak_power", "capped_delay")


def _event_stream():
    """The campaign phase's Poisson NPB stream, its first EVENT_J jobs."""
    from repro_torch.core import JSCC_SYSTEMS
    from repro_torch.data import make_stream_workload
    return _prefix(make_stream_workload(JSCC_SYSTEMS, CAMPAIGN_J, "poisson",
                                        rate=0.5, seed=0), EVENT_J)


def _cap_stream():
    """The example's capped campaign's diurnal stream of CAP_J jobs."""
    from repro_torch.core import JSCC_SYSTEMS
    from repro_torch.data import make_stream_workload
    return make_stream_workload(JSCC_SYSTEMS, CAP_J, arrival="diurnal",
                                rate=0.8, seed=3)


def _cap_policy(caps=CAPS):
    """The example's capped conservative policy, at the phase's window."""
    import numpy as np
    from repro_torch.core.policy import apply_queue_spec, make_policy
    return apply_queue_spec(make_policy(
        "conservative", k=0.10, power_cap=np.array(caps, np.float32)),
        CONS_QUEUE)


def _event_run_stats(name, w, pol, retries, calls, counters, n_small,
                     **kw) -> tuple:
    """One event-core run on the card: the main path with the kth_free
    count from 0, its launches = steps x ``calls`` per step; the host
    syncs of two short prefixes (equal: none in the step loop); ms per
    step, jobs/s, and launches and device µs per step by kernel from a
    profiled ``n_small``-job prefix; idle share."""
    import torch
    from repro_torch.core import events
    from repro_torch.kernels.kth_free import kth_free_cuda
    steps = events.step_count(w, pol, retries)
    kth_free_cuda.launches = 0
    res, seconds, _ = _timed_campaign(w, **kw)
    n_main = kth_free_cuda.launches
    _count(counters, "kth_free", f"event_campaign.{name}", n_main)
    check(n_main == steps * calls,
          f"{name}: kth_free launches {n_main} != {calls} x {steps} steps")
    check(bool(torch.isfinite(res.finish).all()), f"{name}: finite finish")
    check(bool((res.finish > res.start).all()), f"{name}: every job runs")
    syncs = {n: _sync_count(lambda: _campaign(_prefix(w, n), **kw))
             for n in (n_small, 2 * n_small)}
    check(syncs[n_small] == syncs[2 * n_small],
          f"{name}: host syncs grow with J (none allowed in the step): "
          f"{syncs}")
    small = _prefix(w, n_small)
    small_steps = events.step_count(small, pol, retries)
    per_step, busy_us, by_kernel = _launches_per_step(small,
                                                      steps=small_steps, **kw)
    step_us = seconds / steps * 1e6
    J, B = len(w.prog), res.makespan.numel()
    return res, dict(
        jobs=J, lanes=B, steps=steps, seconds=seconds,
        ms_per_step=seconds / steps * 1e3, jobs_per_s=J * B / seconds,
        kth_free_launches=n_main, kth_free_launches_per_step=n_main / steps,
        cuda_launches_per_step=per_step, device_busy_us_per_step=busy_us,
        device_us_per_step_by_kernel=by_kernel,
        device_idle_share=(None if busy_us is None
                           else 1.0 - busy_us / step_us),
        host_syncs_per_run=syncs, profiled_jobs=n_small,
        profiled_steps=small_steps)


def _policy_of(queue=None):
    """The policy ``_campaign`` builds for ``queue``."""
    import numpy as np
    from repro_torch.core.policy import apply_queue_spec, make_policy
    pol = make_policy("paper", k=np.array(CAMPAIGN_KS, np.float32))
    return apply_queue_spec(pol, queue) if queue else pol


def _power_order_check() -> dict:
    """The cluster draw on the card, added in the reference's order by
    ``segment_reduce``, equals the same order added one element at a time
    (float32, one add per element) on a random [20, 4, 136] table."""
    import torch
    from repro_torch.core import events
    g = torch.Generator().manual_seed(7)
    draw = (torch.rand((20, 4, 136), generator=g) * 400).cuda()
    idx, offsets, _ = order = events.power_order(4, 136, "cuda")
    got = events._cluster_power(draw, order)
    flat = draw.reshape(20, -1)[:, idx]
    total = torch.zeros(20, device="cuda")
    for lo, hi in zip(offsets[:-1].tolist(), offsets[1:].tolist()):
        part = torch.zeros(20, device="cuda")
        for i in range(lo, hi):
            part = part + flat[:, i]
        total = total + part
    check(torch.equal(got, total), "segment_reduce does not add the cluster "
          "draw in order on the card")
    return dict(lanes=20, windows=len(offsets) - 1, equal=True)


def phase_event_campaign(counters: dict) -> dict:
    """The event-granular cores on the card at the SCC's full width (the
    four JSCC systems, maxN 136, window 16 for the backfilling queues):
    FCFS with failure re-queue, FCFS with stragglers against the arrival
    core, event-driven EASY, the example's capped conservative campaign,
    the reference ablation's queue comparison and the DVFS lattice."""
    import numpy as np
    import torch
    from repro_torch.core import JSCC_SYSTEMS, Scheduler, make_npb_workload
    from repro_torch.core.policy import make_policy
    from repro_torch.data import (load_swf, make_stream_workload, swf_lines,
                                  synthetic_swf_arrays, workload_from_trace)
    from repro_torch.kernels.kth_free import kth_free_cuda
    w = _event_stream()
    J = EVENT_J
    # the sync detector's first use in a process counts one more
    probe = _sync_count(lambda: torch.ones(1, device="cuda").sum().item())
    check(probe >= 1, "sync debug mode reports no sync for .item()")
    out = {}

    def put(run, stats):
        out[run] = stats
        emit("event_campaign", run=run, **stats)

    put("power_order", _power_order_check())

    # (a) FCFS on the event clock, failures re-queue: one kth_free call a
    # step (the shared slot evaluation)
    kw = dict(engine="events", queue=EVENT_FCFS)
    a, stats = _event_run_stats("fcfs_retries", w, _policy_of(EVENT_FCFS),
                                True, 1, counters, 25, **kw)
    check(stats["steps"] == 7 * J + 4, "retries step count")
    # its twins on the same stream: the sort placer, totals_only
    kth_free_cuda.launches = 0
    srt = _campaign(w, placer="sort", **kw)
    check(kth_free_cuda.launches == 0, "placer='sort' launched the kernel")
    _same(a, srt, EVENT_FIELDS, (), "fcfs_retries kernel/sort")
    _totals_agree(a, _campaign(w, totals_only=True, **kw), "fcfs_retries")
    put("fcfs_retries", stats)

    # (b) FCFS on the event clock with stragglers only: the reference's
    # invariant, bit-equal to the arrival core on the same card
    kw = dict(engine="events", faults=STRAGGLERS, queue=EVENT_FCFS)
    b, stats = _event_run_stats("fcfs", w, _policy_of(EVENT_FCFS), False,
                                1, counters, 40, **kw)
    arrival = _campaign(w, faults=STRAGGLERS)
    _same(arrival, b, FCFS_FIELDS, (), "events/arrival FCFS")
    check(bool((b.n_backfilled == 0).all()), "event FCFS backfilled")
    put("fcfs", stats)

    # (c) event-driven EASY, window 16: the slot evaluation and the head
    # recheck, two kth_free calls a step
    kw = dict(engine="events", faults=STRAGGLERS, queue=EASY_QUEUE)
    c, stats = _event_run_stats("easy", w, _policy_of(EASY_QUEUE), False,
                                2, counters, 40, **kw)
    put("easy", dict(stats, n_backfilled=c.n_backfilled.flatten().tolist()))

    # (d) the example's capped conservative campaign: one kth_free call a
    # step (the realizability rows [4, 17, 136])
    wc = _cap_stream()
    kw = dict(policy=_cap_policy(), faults=None, seeds=0)
    d, stats = _event_run_stats("cons_capped", wc, kw["policy"], False, 1,
                                counters, 30, **kw)
    check(stats["steps"] == 5 * CAP_J + 4, "cons step count")
    peak = d.peak_power.cpu().numpy()
    mk = d.makespan.cpu().numpy()
    for i, cap in enumerate(CAPS[:-1]):
        check(peak[i] <= cap * (1 + 1e-5), f"peak {peak[i]} over cap {cap}")
    check(bool((np.diff(mk) <= 0).all()),
          f"makespan must not fall as the cap tightens: {mk.tolist()}")
    wp = _prefix(wc, EVENT_TWIN_J)
    capped = _campaign(wp, **kw)
    _totals_agree(capped, _campaign(wp, totals_only=True, **kw),
                  "cons_capped")
    unc = _campaign(wp, policy=make_policy("conservative", k=0.10),
                    faults=None, seeds=0, queue=CONS_QUEUE)
    for f in EVENT_FIELDS:
        x, y = getattr(capped, f), getattr(unc, f)
        check(torch.equal(x[-1], y), f"inf-cap lane != uncapped run on {f}")
    put("cons_capped", dict(
        stats, caps=list(CAPS), peak_power=peak.tolist(),
        makespan=mk.tolist(), capped_delay=d.capped_delay.cpu().tolist(),
        idle_energy=d.idle_energy.cpu().tolist(),
        n_backfilled=d.n_backfilled.cpu().tolist()))

    # (e) the reference ablation's queue comparison: conservative waits
    # less than EASY on both of its streams
    streams = {
        "swf": workload_from_trace(load_swf(swf_lines(
            *synthetic_swf_arrays(250, 11))), JSCC_SYSTEMS),
        "diurnal": make_stream_workload(JSCC_SYSTEMS, 300,
                                        arrival="diurnal", rate=0.8, seed=3,
                                        pred_noise=0.05)}
    ablation = {}
    for tag, ws in streams.items():
        waits = {}
        for queue in ("fcfs", "easy_backfill:window=16",
                      "conservative:window=16"):
            r = Scheduler(make_policy("paper", k=0.10), warm_start=True,
                          queue=queue).run(ws)
            waits[queue.split(":")[0]] = float(r.mean_wait)
        check(waits["conservative"] < waits["easy_backfill"],
              f"{tag}: conservative's mean wait is not below EASY's "
              f"{waits}")
        ablation[tag] = waits
    put("ablation_mean_wait", ablation)

    # (f) the DVFS Pareto lattice (``benchmarks/dvfs_pareto.py``): cap x
    # freq_weight x K, every binding cap holds
    wn = make_npb_workload(JSCC_SYSTEMS, repeats=4)
    scale = float(np.median(wn.C_true) / np.median(wn.T_true))
    caps, fws, ks = (x.ravel() for x in np.meshgrid(
        np.array([45e3, 55e3, 1e30], np.float32),
        scale * np.array([0.0, 0.25, 1.0, 4.0], np.float32),
        np.array([0.10, 0.50], np.float32), indexing="ij"))
    r = Scheduler(make_policy("dvfs_paper", k=ks, freq_weight=fws,
                              power_cap=caps), warm_start=True).run(wn)
    pk = r.peak_power.cpu().numpy()
    for i, cap in enumerate(caps):
        if cap < 1e29:
            check(pk[i] <= cap * (1 + 1e-5), f"DVFS peak {pk[i]} > {cap}")
    put("dvfs_lattice", dict(
        points=len(caps), peak_power=pk.tolist(),
        total_energy=r.total_energy.cpu().tolist(),
        makespan=r.makespan.cpu().tolist(),
        tier_counts=r.tier_counts.cpu().tolist()))
    return out


def _cli(argv):
    """``repro_torch.launch.schedule.main(argv)``: its result and the
    lines it printed."""
    import contextlib
    import io
    from repro_torch.launch import schedule
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = schedule.main(argv)
    return res, out.getvalue().splitlines()


def phase_schedule_cli() -> None:
    """The scheduler CLI on the card: the paper suite, an EASY stream, the
    SWF fixture as an EASY campaign and the reference's two conservative
    spellings (one under a 60 kW cap) print the facade's totals on the
    same inputs, and the conservative ones its power line."""
    import numpy as np
    import torch
    from repro_torch.core import (JSCC_SYSTEMS, FaultConfig, Scheduler,
                                  make_npb_workload)
    from repro_torch.core.policy import make_policy
    from repro_torch.data import (NPB_LARGE, NPB_SMALL, load_swf,
                                  make_stream_workload, workload_from_trace)
    fault = FaultConfig()
    trace = os.path.join(ROOT, "tests", "data", "jscc_sample.swf.gz")
    ks = np.array([0.0, 0.1, 0.3], np.float32)
    mix = {NPB_SMALL: 0.5, NPB_LARGE: 0.5}
    cases = {
        "paper": ([], make_npb_workload(JSCC_SYSTEMS),
                  Scheduler(make_policy("paper", k=0.1), faults=fault,
                            warm_start=True)),
        "easy_jobs": (
            ["--jobs", "200", "--scenario", "diurnal", "--queue", EASY_QUEUE],
            make_stream_workload(JSCC_SYSTEMS, 200, arrival="diurnal",
                                 rate=0.125, mix=mix),
            Scheduler(make_policy("paper", k=0.1), faults=fault,
                      warm_start=True, queue=EASY_QUEUE)),
        "easy_trace_campaign": (
            ["--trace", trace, "--queue", EASY_QUEUE, "--campaign-k",
             "0,0.1,0.3", "--campaign-seeds", "2"],
            workload_from_trace(load_swf(trace), JSCC_SYSTEMS),
            Scheduler(make_policy("paper", k=ks), faults=fault,
                      seeds=[0, 1], warm_start=True, queue=EASY_QUEUE)),
        "conservative_capped": (
            ["--jobs", "200", "--scenario", "bursty", "--queue",
             "conservative", "--power-cap", "60000"],
            make_stream_workload(JSCC_SYSTEMS, 200, arrival="bursty",
                                 rate=0.125, mix=mix),
            Scheduler(make_policy("paper", k=0.1), faults=fault,
                      warm_start=True, queue="conservative",
                      power_cap=60000.0)),
        "conservative_jobs": (
            ["--jobs", "200", "--scenario", "diurnal", "--queue",
             "conservative:window=16"],
            make_stream_workload(JSCC_SYSTEMS, 200, arrival="diurnal",
                                 rate=0.125, mix=mix),
            Scheduler(make_policy("paper", k=0.1), faults=fault,
                      warm_start=True, queue="conservative:window=16")),
    }
    for name, (argv, w, sched) in cases.items():
        res, lines = _cli(argv)
        ref = sched.run(w)
        check(res.total_energy.is_cuda, f"CLI {name} ran off the card")
        for f in ("total_energy", "makespan", "total_wait", "system",
                  "n_backfilled"):
            check(torch.equal(getattr(res, f), getattr(ref, f)),
                  f"CLI {name}: {f} != the facade's")
        E = ref.total_energy.cpu().numpy()
        M = ref.makespan.cpu().numpy()
        Wt = ref.total_wait.cpu().numpy()
        if ref.axes:
            want = [f"{k:.2f},{E[i].mean():.0f},{E[i].std():.0f},"
                    f"{M[i].mean():.1f},{Wt[i].mean():.1f}"
                    for i, k in enumerate(ks)]
            got = [ln.rsplit(",", 1)[0] for ln in lines[2:]]
        else:
            want = [f"energy={float(E) / 1e3:.1f} kJ  makespan="
                    f"{float(M):.1f} s  total_wait={float(Wt):.1f} s"]
            got = [lines[1].split("  mean_slowdown")[0]]
        if name.startswith("conservative"):
            # the event core's power line, from the facade's fields
            cap = "60000 W" if "--power-cap" in argv else "none"
            want.append(f"peak_power={float(ref.peak_power) / 1e3:.1f} kW "
                        f"(cap {cap})  capped_delay="
                        f"{float(ref.capped_delay):.1f} s  idle_energy="
                        f"{float(ref.idle_energy) / 1e3:.1f} kJ")
            got.append(lines[2])
        check(got == want, f"CLI {name} printed {got}, facade {want}")
        emit("schedule_cli", case=name, argv=argv, lines=lines,
             n_backfilled=ref.n_backfilled.flatten().tolist())


def _wrappers() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from repro_torch.kernels.ep import ep_pass_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.is_hist import key_histogram_cuda
    from repro_torch.kernels.kth_free import kth_free_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.kernels.stencil3d import stencil7_cuda
    return {"kth_free": kth_free_cuda, "ep": ep_pass_cuda,
            "is_hist": key_histogram_cuda, "stencil7": stencil7_cuda,
            "flash_attention": flash_attention_cuda,
            "ssd_scan": ssd_scan_cuda}


def _expected_launches(name, size):
    """(kernel, launches) of one run of program ``name`` at ``size``."""
    if name == "EP":                                      # batch_pow 16
        from repro_torch.workloads.ep import _DRAW_PAIRS
        per_draw = max(1, _DRAW_PAIRS // 2 ** 16)
        return "ep", -(-2 ** (size["ep_m"] - 16) // per_draw)  # draw passes
    if name == "IS":
        return "is_hist", 10                              # iterations
    iters = size["cfd_iters"]
    return "stencil7", 2 * iters if name == "LU" else iters


def _sizes_equal(name, a, b) -> bool:
    """Whether program ``name`` runs at the same size under scales ``a``
    and ``b``."""
    keys = {"EP": ("ep_m",), "IS": ("is_pow",)}.get(
        name, ("cfd_nx", "cfd_iters"))
    return all(a[k] == b[k] for k in keys)


def _same_result(name, a, b) -> None:
    """A run through the kernels against its ``force="torch"`` run on the
    card: equal, but for EP's sums (rtol 1e-6)."""
    import torch
    for k, v in a.items():
        if not torch.is_tensor(v):
            check(v == b[k], f"{name} {k}: {v} != {b[k]}")
        elif name == "EP" and k in ("sx", "sy"):
            check(bool((v - b[k]).abs() <= 1e-6 * b[k].abs()),
                  f"EP {k} beyond rtol 1e-6: {float(v)} {float(b[k])}")
        else:
            check(torch.equal(v, b[k]), f"{name} {k}: kernel != plain run")


#: depth-cut copies of the class A runs, profiled for the idle share: the
#: same per-iteration shapes, fewer iterations
_PROFILED = {"EP": {"m": 24}, "IS": {"n_pow": 23, "iterations": 10},
             "BT": {"nx": 64, "iters": 4}, "SP": {"nx": 64, "iters": 4},
             "LU": {"nx": 64, "iters": 4}}


def _idle_share(name) -> dict:
    """Device idle share of a depth-cut class A run: 1 - device busy time
    (profiler) / wall time of the same run unprofiled."""
    import torch
    from repro_torch.workloads import run_cfd, run_ep, run_is
    kw = _PROFILED[name]
    run = {"EP": lambda: run_ep(**kw), "IS": lambda: run_is(**kw)}.get(
        name, lambda: run_cfd(variant=name, **kw))
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = _device_busy_us(run)
    return dict(profiled=kw, profiled_wall_us=wall_us,
                device_busy_us=busy_us,
                device_idle_share=(None if busy_us is None
                                   else 1.0 - busy_us / wall_us))


def phase_workloads(counters: dict) -> None:
    """The NPB analogues through ``run_benchmark`` on the card: the main
    path of this slice.  Every kernel count is set to 0 just before each
    run and read just after; the class A runs' counts go to ``counters``.
    A program whose ``small`` size is its class A size runs once, at A."""
    import torch
    from repro_torch.workloads import BENCHMARKS, SCALES, run_benchmark
    wrappers = _wrappers()
    for scale in ("small", "A"):
        for name in BENCHMARKS:
            if scale == "small" and _sizes_equal(name, SCALES["small"],
                                                 SCALES["A"]):
                continue
            kernel, expect = _expected_launches(name, SCALES[scale])
            run_benchmark(name, "smoke")                  # warm up
            torch.cuda.synchronize()
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            res, ok, ops = run_benchmark(name, scale)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: w.launches for k, w in wrappers.items()}
            check(ok, f"{name} at {scale} fails its verification")
            check(launches == {**dict.fromkeys(wrappers, 0), kernel: expect},
                  f"{name} at {scale}: kernel launches {launches}, "
                  f"expected {expect} of {kernel} only")
            if scale == "A":
                counters[kernel] = counters.get(kernel, 0) + \
                    launches[kernel]
            t0 = time.perf_counter()
            plain, plain_ok, _ = run_benchmark(name, scale, force="torch")
            torch.cuda.synchronize()
            plain_wall = time.perf_counter() - t0
            check(plain_ok, f"{name} at {scale}: the plain run fails")
            _same_result(name, res, plain)
            row = dict(program=name, scale=scale, verified=ok,
                       kernel=kernel, launches=launches[kernel],
                       seconds=wall, mops_per_s=ops / 1e6 / wall,
                       plain_seconds=plain_wall, equal_to_plain=True)
            if scale == "A":
                row.update(_idle_share(name))
            if name == "EP":
                row.update(accepted=float(res["accepted"]),
                           sx=float(res["sx"]), sy=float(res["sy"]))
            elif name == "IS":
                row.update(total_counted=float(res["total_counted"]))
            else:
                r = res["residuals"]
                row.update(residual_first=float(r[0]),
                           residual_last=float(r[-1]))
            emit("workloads", **row)


def _place(mode, store, p, avail, k, dev):
    import torch
    from repro_torch.core.algorithm import select_system
    from repro_torch.utils import prng
    c_row = torch.as_tensor(store.C[p], dtype=torch.float32, device=dev)
    t_row = torch.as_tensor(store.T[p], dtype=torch.float32, device=dev)
    return int(select_system(
        mode, c_row=c_row, t_row=t_row,
        runs_row=torch.as_tensor(store.runs[p], dtype=torch.int32,
                                 device=dev),
        avail_row=torch.as_tensor(avail, dtype=torch.float32, device=dev),
        k=torch.tensor(k, dtype=torch.float32, device=dev),
        c_pred_row=c_row, t_pred_row=t_row, key=prng.key(p, device=dev)))


def _executed_campaign(mode, jobs, k, degrade_after):
    """One executed campaign: each job is placed by ``select_system``,
    EXECUTED on the card at ``smoke`` size (it must verify), and its
    measured wall time, mapped onto the chosen system's modelled clock,
    feeds the profile store."""
    import numpy as np
    import torch
    from repro_torch.core import JSCC_SYSTEMS, NPB_NODES, NPB_PROFILES
    from repro_torch.core.profiles import ProfileStore
    from repro_torch.core.workload_model import predict_energy
    from repro_torch.workloads import run_benchmark
    dev = torch.device("cuda")
    systems = list(JSCC_SYSTEMS)
    names = [sy.name for sy in systems]
    progs = sorted(set(jobs))
    pidx = {n: i for i, n in enumerate(progs)}
    store = ProfileStore(len(progs), len(systems))
    free = np.zeros(len(systems))
    slowdown = np.ones(len(systems))
    total_e, log = 0.0, []
    for j, prog in enumerate(jobs):
        if j == degrade_after:
            slowdown[names.index("Skylake")] = 3.0      # degraded system
        p = pidx[prog]
        s = _place(mode, store, p, free, k, dev)
        t0 = time.perf_counter()
        _, ok, _ = run_benchmark(prog, "smoke")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(ok, f"executed job {j} ({prog}) fails its verification")
        prof = NPB_PROFILES[prog]
        _, w_avg, t_model = predict_energy(
            prof, systems[s], NPB_NODES[prog][names[s]])
        t_run = t_model * slowdown[s] * (0.9 + 0.2 * (wall % 1.0))
        e_run = w_avg * t_run
        store.update(p, s, e_run / (prof.flops / 1e6), t_run)
        free[s] += t_run
        total_e += e_run
        log.append((prog, names[s], wall))
    return total_e, float(free.max()), log


def phase_executed_campaign() -> None:
    from repro_torch.data import sample_programs
    from repro_torch.workloads import SCALES
    n_jobs, k = 28, 0.10
    jobs = list(sample_programs(n_jobs, seed=0))
    wrappers = _wrappers()
    out = {}
    for mode in ("paper", "fastest", "first_free"):
        before = {n: w.launches for n, w in wrappers.items()}
        t0 = time.perf_counter()
        energy, makespan, log = _executed_campaign(mode, jobs, k,
                                                   n_jobs // 2)
        seconds = time.perf_counter() - t0
        launches = {n: w.launches - before[n] for n, w in wrappers.items()}
        expect = dict.fromkeys(wrappers, 0)
        for prog in jobs:
            kernel, count = _expected_launches(prog, SCALES["smoke"])
            expect[kernel] += count
        check(launches == expect,
              f"executed jobs launched {launches}, expected {expect}")
        out[mode] = (energy, makespan)
        emit("executed_campaign", mode=mode, jobs=n_jobs, k=k,
             energy_j=energy, makespan_s=makespan, seconds=seconds,
             verified=n_jobs, launches=launches,
             placements=[f"{p}->{sy}" for p, sy, _ in log],
             job_wall_s=[w for _, _, w in log])
    (e_p, m_p), (e_f, m_f) = out["paper"], out["fastest"]
    emit("executed_campaign", paper_vs_fastest_energy=(e_p - e_f) / e_f,
         paper_vs_fastest_makespan=(m_p - m_f) / m_f)


#: the serving cells: phase -> (arch, the kernel its prefill launches once
#: per layer, |logits(kernel prefill) - logits(force="torch" prefill)|
#: band by dtype).  PERF.md "Parity bands": in bf16 the hidden state is
#: bf16, so a one-ulp difference in a layer's kernel output carries
#: through every later layer (tinyllama: about six bf16 steps at the
#: largest logit over 22 layers).  mamba2's 48 random-weight layers
#: amplify any rounding difference: on an H100 its plain version against
#: itself at chunk 128 (the same sums, rounded in another order) differs
#: by 0.54 in bf16 and 5.5e-4 in f32 at logits up to 4.1, and the kernel
#: by 0.57 and 7.3e-4; ``serve_ssm`` measures and prints that floor
SERVE_CELLS = {
    "serve": ("tinyllama-1.1b", "flash_attention",
              {"bfloat16": 0.1, "float32": 1e-3}),
    "serve_ssm": ("mamba2-780m", "ssd_scan",
                  {"bfloat16": 1.0, "float32": 1e-3}),
}
#: parameters of the full-size configs (the reference's ``param_specs``)
SERVE_PARAMS = {"tinyllama-1.1b": 1_100_048_384, "mamba2-780m": 780_148_992}


def _decode_loop_stats(api, params, logits, steps):
    """Device idle share of ``steps`` greedy decode steps (1 - device busy
    time from the profiler / wall of the same loop unprofiled), device
    operations per step, and the host synchronisations of the loop at two
    lengths (which must not grow with the steps)."""
    import torch
    from repro_torch.launch.serve import greedy_decode
    cache = api.init_decode_cache(logits.shape[0], steps + 1)

    def run(n=steps):
        return greedy_decode(api, params, cache, logits, 0, n)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, n_ops = _device_busy_us(run, count=True)
    _sync_count(lambda: run(2))       # the detector's first call (one sync)
    syncs = {n: _sync_count(lambda: run(n)) for n in (4, 8)}
    check(syncs[4] == syncs[8],
          f"host syncs change with the decode steps: {syncs}")
    return dict(decode_wall_us=wall_us, decode_device_busy_us=busy_us,
                decode_device_idle_share=(None if busy_us is None
                                          else 1.0 - busy_us / wall_us),
                decode_device_ops_per_step=n_ops / steps,
                decode_host_syncs=syncs)


def _prefill_pair(api, params, batch, counted, wrappers, kernel, band):
    """The kernel prefill (``kernel`` launched once per layer, nothing
    else) and its ``force="torch"`` run (nothing launched): logits,
    seconds and their max abs difference, held to ``band``."""
    import torch
    cfg = api.cfg
    logits, t_kernel, launches = counted(lambda: api.prefill(params, batch))
    check(launches == {**dict.fromkeys(wrappers, 0), kernel: cfg.n_layers},
          f"{cfg.dtype} prefill launches {launches}, expected "
          f"{cfg.n_layers} {kernel}")
    plain, t_plain, plain_launches = counted(
        lambda: api.prefill(params, batch, force="torch"))
    check(not any(plain_launches.values()),
          f"force='torch' launched {plain_launches}")
    check(logits.shape == (batch["tokens"].shape[0], cfg.vocab_size)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), "prefill logits")
    diff = float((logits - plain).abs().max())
    check(diff <= band[cfg.dtype],
          f"{cfg.dtype} kernel vs plain prefill logits differ by {diff} "
          f"(band {band[cfg.dtype]})")
    return logits, plain, t_kernel, t_plain, launches, diff


def _chunk_floor(api, params, batch, plain):
    """max |plain prefill logits - the plain prefill at half the SSD
    chunk|: the same sums rounded in another order, the floor the kernel's
    difference is read against."""
    import dataclasses
    from repro_torch.models import build_model
    cfg = api.cfg
    half = build_model(cfg.with_overrides(ssm=dataclasses.replace(
        cfg.ssm, chunk=cfg.ssm.chunk // 2)))
    return float((half.prefill(params, batch, force="torch") - plain)
                 .abs().max())


def phase_serve(counters: dict, phase: str) -> None:
    """One serving cell at full width on the card: the main path of its
    slice.  Every kernel count is set to 0 just before each run and read
    just after; the 4 x 4,096 prefill's counts go to ``counters``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    arch, kernel, band = SERVE_CELLS[phase]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.cuda.reset_peak_memory_stats()
    wrappers = _wrappers()

    def counted(fn):
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {
            n: w.launches for n, w in wrappers.items()}

    cfg = get_config(arch)
    api = build_model(cfg)
    t0 = time.perf_counter()
    params = api.init_params(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    check(n_params == SERVE_PARAMS[arch], f"{arch}: {n_params} parameters")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 4096), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens}
    api.prefill(params, batch)                            # warm up
    logits, plain, t_prefill, t_plain, launches, diff = _prefill_pair(
        api, params, batch, counted, wrappers, kernel, band)
    counters[kernel] = launches[kernel]
    route = wrappers[kernel].last_route
    check(route == "tensor-core", f"the bf16 prefill took the {route} "
          f"route of {kernel}")
    top2 = plain.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    clear = margin > band[cfg.dtype]
    same = logits.argmax(-1) == plain.argmax(-1)
    check(bool(same[clear].all()), "argmax differs where the top-2 margin "
          f"exceeds the band: margins {margin.tolist()}")
    extra = {}
    if kernel == "flash_attention":
        # below 2,048 tokens the reference's rule takes plain_attention
        short, t_short, launches = counted(
            lambda: api.prefill(params, {"tokens": tokens[:, :1024]}))
        check(not any(launches.values()),
              f"1,024-token prefill launched {launches} (plain_attention)")
        check(bool(torch.isfinite(short).all()), "1,024-token prefill logits")
        extra = dict(short_prefill_s=t_short, short_prefill_launches=0)
    else:
        extra = dict(plain_half_chunk_logits_max_abs_diff=_chunk_floor(
            api, params, batch, plain))

    res, t_main, launches = counted(lambda: serve.main(["--arch", arch]))
    check(not any(launches.values()), f"decode launched {launches}")
    check(res["steps"] == 31 and bool(torch.isfinite(res["logits"]).all()),
          "serve.main decodes 31 timed steps with finite logits")
    idle = _decode_loop_stats(api, params, logits, 31)
    peak = torch.cuda.max_memory_allocated()

    # the same prefill in f32: kernel and plain version within f32 noise
    del params
    api32 = build_model(cfg.with_overrides(dtype="float32"))
    params32 = api32.init_params(0)
    _, plain32, t32, t32_plain, _, diff32 = _prefill_pair(
        api32, params32, batch, counted, wrappers, kernel, band)
    route32 = wrappers[kernel].last_route
    check(route32 == "f32-core", f"the f32 prefill took the {route32} "
          f"route of {kernel}")
    if kernel == "ssd_scan":
        extra["f32_plain_half_chunk_logits_max_abs_diff"] = _chunk_floor(
            api32, params32, batch, plain32)
    del params32
    emit(phase, arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
         dtype=cfg.dtype, params=n_params, init_s=init_s,
         prefill_shape=list(tokens.shape), prefill_s=t_prefill,
         prefill_tokens_per_s=tokens.numel() / t_prefill,
         prefill_kernel=kernel, prefill_launches=counters[kernel],
         prefill_route=route, f32_prefill_route=route32,
         prefill_plain_s=t_plain,
         prefill_plain_tokens_per_s=tokens.numel() / t_plain,
         logits_max_abs_diff=diff, logit_band=band[cfg.dtype],
         logits_abs_max=float(plain.abs().max()),
         top2_margin=margin.tolist(), argmax_equal=same.tolist(), **extra,
         decode_batch=4, decode_steps=res["steps"],
         decode_tokens_per_s=res["tokens_per_s"],
         decode_ms_per_step=res["ms_per_step"], serve_main_s=t_main, **idle,
         max_memory_allocated=peak, f32_prefill_s=t32,
         f32_prefill_plain_s=t32_plain, f32_logits_max_abs_diff=diff32,
         f32_logit_band=band["float32"],
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         allow_bf16_reduced_precision_reduction=(
             torch.backends.cuda.matmul
             .allow_bf16_reduced_precision_reduction),
         nvidia_smi=nvidia_smi())


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _phases(counters: dict) -> dict:
    """The phases after ``build``, by name, in the order they run; the
    main-path phases add their kernels' launch counts to ``counters``."""
    return {
        "kernel": phase_kernels,
        "kernel_flash": phase_kernel_flash,
        "kernel_ssd": phase_kernel_ssd,
        "paper": phase_paper,
        "campaign": lambda: phase_campaign(counters),
        "easy_campaign": lambda: phase_easy_campaign(counters),
        "event_campaign": lambda: phase_event_campaign(counters),
        "cross_device": phase_cross_device,
        "schedule_cli": phase_schedule_cli,
        "workloads": lambda: phase_workloads(counters),
        "executed_campaign": phase_executed_campaign,
        "serve": lambda: phase_serve(counters, "serve"),
        "serve_ssm": lambda: phase_serve(counters, "serve_ssm"),
    }


def main(argv=None) -> int:
    import torch
    names = list(_phases({}))
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", type=lambda s: s.split(","), default=None,
                    help="comma-separated phases of " + ",".join(names) +
                         " to run after build (no result lines)")
    ap.add_argument("--log", default=None,
                    help="also append every phase line to this file")
    args = ap.parse_args(argv)
    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
        LOG.append(args.log)
    only = args.only
    if only is not None and set(only) - set(names):
        ap.error(f"unknown phases {sorted(set(only) - set(names))}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on "
              "the card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_build()
    counters: dict = {}
    results, phase_s = {}, {}
    for name, fn in _phases(counters).items():
        if only is None or name in only:
            t0 = time.perf_counter()
            results[name] = fn()
            phase_s[name] = time.perf_counter() - t0
    if only is not None:
        emit("done", seconds=time.perf_counter() - t_start, only=only,
             phase_seconds=phase_s)
        return 0
    kern = {**results["kernel"], "flash_attention": results["kernel_flash"],
            "ssd_scan": results["kernel_ssd"]}
    meta = {  # name: (source, replaced TPU kernel, how it is checked)
        "kth_free": ("src/repro_torch/kernels/kth_free/csrc/kth_free.cu",
                     "src/repro/kernels/kth_free/kernel.py:81",
                     "torch.equal vs twin and sort"),
        "ep": ("src/repro_torch/kernels/ep/csrc/ep.cu",
               "src/repro/kernels/ep/kernel.py:60",
               "hist torch.equal vs plain; sums rtol 1e-6; the draw pass "
               "[16, 2, 2^16] into a carry"),
        "is_hist": ("src/repro_torch/kernels/is_hist/csrc/is_hist.cu",
                    "src/repro/kernels/is_hist/kernel.py:37",
                    "torch.equal vs plain"),
        "stencil7": ("src/repro_torch/kernels/stencil3d/csrc/stencil7.cu",
                     "src/repro/kernels/stencil3d/kernel.py:51",
                     "torch.equal vs plain"),
        "flash_attention": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:68",
            "vs blocked plain and attention_ref: atol 3e-5 f32, 3e-2 bf16 "
            "and 2 bf16 ulps of |ref| + 1e-4"),
        "ssd_scan": (
            "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
            "src/repro/kernels/ssd_scan/kernel.py:76",
            "vs plain: atol 2e-4 at the reference's shapes; 2e-4 + 1e-4 "
            "max|plain| at the path shape and l 32,768; views == copies"),
    }
    kernels = []
    for name, (source, replaces, how) in meta.items():
        k = kern[name]
        check(counters.get(name, 0) > 0,
              f"{name} was not launched on its main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counters[name],
            "launches_by_path": counters.get("by_path", {}).get(name),
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_us"] / 1e3,
            "device_ms": (None if k["kernel_device_us"] is None
                          else k["kernel_device_us"] / 1e3),
            "host_ms": (k["host_us"] / 1e3 if "host_us" in k else None),
            "plain_ms": k["plain_us"] / 1e3, "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": (None if k["library_us"] is None
                           else k["library_us"] / 1e3),
            "library": k["library"], "check": how})
    emit("done", seconds=time.perf_counter() - t_start, phase_seconds=phase_s,
         campaign_ms_per_step=results["campaign"]["ms_per_step"],
         easy_ms_per_step=results["easy_campaign"]["ms_per_step"],
         event_ms_per_step={run: v["ms_per_step"] for run, v
                            in results["event_campaign"].items()
                            if "ms_per_step" in v})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
