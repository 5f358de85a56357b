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
               32/64/96/128/256, f32 and bf16) and strided views (fused
               QKV, head-major, f32 and bf16); the route each case took
               (bf16 at head dims 64, 96 and 128: the tensor-core kernel,
               else the f32-core one); kernel / host / device / plain /
               ``F.scaled_dot_product_attention`` times, the bound and the
               tensor-core route's issued-operation floor; head dim 96 at
               phi-3-vision's path shape (q [4, 4096, 32, 96], causal,
               bf16 and f32) with its times, bound and SDPA; and one
               b = 1, s = 32,768 call with its last rows checked
  kernel_ssd   the SSD chunk-scan kernel against its plain version: the
               reference's test shapes (atol 2e-4, f32 and bf16), its
               chunk-invariance case (16 vs 64), the mamba2-780m path shape
               (x [4, 4096, 48, 64], B/C [4, 4096, 1, 128], chunk 256,
               bf16 and f32, as strided model-layout views; within 2e-4 +
               1e-4 max |plain|, and bit-equal to its run on contiguous
               copies), the jamba-v0.1-52b path shape (x [2, 4096, 128,
               64], B/C [2, 4096, 1, 16], chunk 256, bf16, the same band;
               device time and bound) and one b = 1, l = 32,768 call; the
               route (bf16:
               four tensor-core launches, f32: three f32-core ones);
               kernel / host / device / per-launch device / plain times,
               the bound and the tensor-core route's issued-operation
               floor (no single PyTorch call computes an SSD scan)
  paper        the paper's NPB K sweep; the paper-claim assertions hold
  campaign     the documented campaign: the first 5,000 of its 10,000
               Poisson NPB jobs at rate 0.5 (all 10,000 until PR 26), K in
               {0, .05, .1, .2, .3} x 4 seeds, stragglers and
               failures, warm start, full and totals_only.  The kernel's
               launch count rises by exactly J per run, the twin placer
               gives bit-equal results on the first 2,000 jobs (every
               field against the kernel on them, per-job values against
               the whole run), and the step loop makes no host
               synchronisation
  easy_campaign  EASY backfilling, window 16, on the reference ablation's
               contended SWF stream (``synthetic_swf_arrays(10_000)``
               through ``swf_lines``/``load_swf``/``workload_from_trace``,
               the four JSCC systems) cut to its first 5,000 jobs (10,000
               until PR 26), the campaign's grid (20 lanes),
               faults and warm start: the 5,016-step run launches
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
               re-queue on the campaign's stream cut to 250 jobs (500
               until PR 26), its grid (20 lanes) and faults, one kth_free
               launch a step (1,754), ``sort`` placer bit-equal and
               ``totals_only`` totals equal; (b) the same 250 jobs with
               stragglers only (1,004 steps), bit-equal to the arrival
               core's FCFS; (c) event EASY on them, two launches a step;
               (d) the example's capped conservative campaign (the first
               250 of its 1,000 diurnal jobs, caps 45/52/60 kW and none),
               one rows launch a step (1,254): peaks under the caps, makespan
               non-decreasing as the cap tightens, ``totals_only`` equal
               and the uncapped lane equal to an uncapped run;
               each with no host sync in the
               step (two short prefixes make as many syncs), ms per step,
               jobs/s, launches and device µs per step by kernel, idle
               share; (e) conservative's mean wait below EASY's on the
               reference ablation's two streams; (f) the DVFS cap x
               freq_weight x K lattice: binding caps hold, tier counts.
               The twins of (a) and (d), (e) and (f) report no times and
               run in a child process beside ``campaign_scale`` and
               ``cross_device`` (the ``event`` child); their checks run
               before the service phase's first live step
  campaign_scale  campaign scale: (a) each core chunked against its
               monolithic run, bit for bit on every field: FCFS on the
               campaign phase's own 5,000-job kernel run at chunk 4,093;
               EASY (window 16) on the first 1,000 jobs of the EASY stream
               at chunk 97, full and ``totals_only``; the event core's
               FCFS with failure re-queue on the first 200 jobs of the
               event stream at chunk 129; the capped conservative grid
               (the 4 caps) on the first 200 jobs of the cap stream at
               chunk 129, full and ``totals_only``; each chunked run a
               main path of kth_free; launches per step (monolithic, one
               chunk, short chunks) and host syncs chunked against
               monolithic on short prefixes; (b) ``shards="auto"`` and
               ``shards=1`` equal the unsharded run on 2,000 FCFS jobs, one
               shard more than the card count raises ``ValueError``; (c)
               the reference's million-job configuration (two small
               systems, ``ucb``, warm, ``totals_only``, chunk 4,096) on 16
               K x 4 seeds = 64 lanes at J = 10,000 and 30,000 (cut from
               10^6 for the script's time; since PR 26 in a child started
               with ``event_campaign``): peak memory grows by less than
               one [64, 20,000] f32 array, the monolithic peak at 10,000
               beside it, ms per step, jobs/s; (d)
               ``examples/torch_quickstart.py`` and
               ``examples/torch_multi_cluster_campaign.py --jobs 4
               --sim-jobs 500`` exit 0, a SUPPZ round decides as on the
               CPU; (c) and the examples run in processes of their own
               beside (a) and (b)
  cross_device the first 1,000 jobs on the CPU (twin) against the card
               (kernel) within the parity bands of PERF.md; the first
               500 jobs of the EASY stream, full and totals_only; and the
               first 250 jobs of event_campaign's runs (a) and (d); the
               CPU runs come from the ``cross`` child (``cross_part``,
               two threads), started after the build, which also
               computes the ``mirror`` phase's host side
  schedule_cli ``repro_torch.launch.schedule.main`` on the card: the paper
               suite, ``--jobs 200 --scenario diurnal --queue
               easy_backfill:window=16``, the SWF fixture as an EASY
               campaign (K 0, .1, .3 x 2 seeds), and the reference's
               conservative spellings ``--jobs 200 --scenario bursty
               --queue conservative --power-cap 60000`` and ``--jobs 200
               --scenario diurnal --queue conservative:window=16`` print
               the facade's totals on the same inputs, the conservative
               ones also its ``peak_power`` line
  service      the online service, one session (``repro_torch.service``)
               at the CLI's default capacity of 256 and window 16: seven
               live sessions replayed submit-before-drive-past, each
               bit-equal to the batch ``engine="events"`` run of the same
               scheduler on every field of the reference's
               ``tests/test_service.py`` tuple: the campaign stream's
               first 256 jobs with its faults (failure re-queue) under
               FCFS, EASY, conservative and EASY capped at 45 kW, and the
               reference ablation's 250-job SWF stream under the three
               queues; kth_free launched exactly 1 / 2 / 1 times a live
               step (FCFS / EASY / conservative); the EASY session saved
               half way, restored into a fresh dispatcher and finished
               with the same decisions and result; one host sync per
               ``step_once`` and none per ``submit``; five what-ifs 40
               jobs into a session leave its carry and job tensors
               unchanged leaf by leaf; the rollout stopped at its first
               quiescent check equals the full-length one (steps and ms
               of both); the device idle share of driving
               the next 40 jobs; the JSONL CLI as a subprocess over the
               reference docstring's request stream; decision latency
               (µs per ``step_once``: mean, p50, p99, max), steps per
               placed job, what-if ms.  The batch runs and the CLI run in
               two child processes started before ``campaign_scale``
               (whose times compare nothing later) and run beside it,
               ``cross_device`` and ``schedule_cli``; they and the
               ``service_pool`` phase's two children end before the
               first live step
  service_pool the online service's session pool
               (``repro_torch.service.SessionPool``, EASY at window 16,
               capacity 256, the campaign stream's faults with failure
               re-queue): (a) 4 sessions on 4 streams (program orders over
               the campaign stream's first 256 arrivals), differing in K,
               power cap (one at 45 kW) and seed, fed through all-lane
               drives, each bit-equal on its decisions and every field of
               the reference's tuple to an independent ``Dispatcher``;
               (b) 64 K x seed sessions, lane for lane equal to one batch
               ``engine="events"`` run of the 64 points (bit-equal; the
               sums over jobs, which the card reduces in an order that
               follows the lane count, within rtol 1e-6 and bit-equal to
               the batch lane's per-job values reduced at one lane); at
               N = 1, 4 and 64: pool steps, wall µs per pool step (mean,
               p50, p99, max), the per-session share, kth_free launched
               exactly 2 times a pool step, one host sync a pool step and
               none a ``submit``, device operations a pool step and a
               drive's idle share; (c) the 4-lane pool saved mid-stream
               through the writer thread, restored into a fresh pool and
               finished equal to (a)'s, then one lane rolled back while
               the others keep their state bit for bit, and finished
               equal; (d) the ``--pool 4 --decision-log`` CLI killed after
               a checkpoint, ``--restore``d and finished equal to an
               uninterrupted run, whose log carries every decision with
               its session.  The independent sessions, the batch run,
               (c)'s pools and the CLI run in two child processes started
               beside ``cross_device``
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
  mirror       the campaign stream's first 300 jobs over its K grid,
               faults off, on the card under FCFS, EASY (window 16),
               event EASY, conservative, a 52 kW cap and DVFS tiers, each
               lane held against the port's float64 mirror
               ``simulate_py`` on the host (the ``cross`` child;
               conservative with
               ``check_reservations``): systems exact; energy, start,
               total energy and makespan at the reference's differential
               bands where the backfill order agrees, else the card's
               run equal to the port's CPU run; the worst relative error
               per field
  easy_unrolled  ``easy_eval="unrolled"`` against the batched step on
               the ablation's SWF stream cut to 300 jobs, window 16, K
               {0, .1, .2} x 2 seeds with faults: 2 W + 2 = 34 kth_free
               launches a step against 2, placements and starts exact,
               tables within the reference's band; ms a step of both,
               the idle share of a 50-step device-only trace
  serve        tinyllama-1.1b at full width (22 x 2048, bf16, seeded
               weights): a 4 x 4,096-token ``prefill`` launches the flash
               kernel once per layer (the tensor-core route; f32: the
               f32-core one) and agrees with its ``force="torch"``
               run within the band of ``SERVE_CELLS``, also in f32; a
               1,024-token prefill launches it 0 times;
               ``launch.serve.main`` at its defaults (batch 4, 32 tokens,
               max-seq 128) launches no kernel; tokens/s, ms per decode
               step, the decode loop's device idle share (8 steps, a
               trace of the device alone), peak memory
  serve_ssm    the same for mamba2-780m at full width (48 x 1536, bf16,
               780,148,992 seeded parameters): the 4 x 4,096 prefill
               calls the SSD scan kernel once per layer (bf16: the
               tensor-core route, four CUDA launches per call; f32: the
               f32-core one, three) and agrees with ``force="torch"``;
               decode runs no kernel
  serve_moe    moonshot-v1-16b-a3b at full width and depth (48 x 2048, 64
               experts top-6, 28,057,995,264 seeded bf16 parameters): the
               2 x 4,096 prefill launches flash 48 times (tensor-core
               route) and agrees with ``force="torch"`` within the band of
               ``FAMILY_BANDS``, beside its floor (the plain prefill at
               flash block 256), with the routing flips between the two
               runs and the entries dropped at capacity per layer; a
               31-step greedy decode launches nothing; the same prefill in
               f32 at 4 layers within 1e-3; ``serve.main`` at its
               defaults after the phase's weights are freed.  Then
               llama4-scout-17b-a16e at full width, depth cut to 4 (16
               experts top-1, 10,374,067,200 parameters): the prefill
               launches flash 4 times, the same checks, the greedy decode
               on the depth-cut config.  Per-shard MoE dispatch: moonshot's
               [16, 2,048] prefill under ``use_rules(
               make_production_mesh(), lm_rules(False))`` (16 data shards,
               each bucketed on its own; s = 2,048 is the least that takes
               the flash branch): flash 48 times, the kernel route against
               ``force="torch"`` in the band beside its floor, routing
               flips, and the drops per layer against the same prompt in
               one shard
  serve_hybrid jamba-v0.1-52b at full width, one 8-layer group
               (13,267,656,416 parameters): the 2 x 4,096 prefill calls
               the SSD scan 7 times and flash once (tensor-core routes),
               agrees with ``force="torch"`` beside its floor (half the
               SSD chunk), routing flips and drops; 31 greedy steps over
               the mixed cache (1 K/V layer, 7 conv/state) launch nothing;
               f32 at the same group (f32-core routes, within 1e-3); a
               teacher-forced decode of the first 64 tokens equals the
               prefill's last logits within 1e-3 (f32, capacity_factor 8,
               SSD chunk 64)
  serve_encdec whisper-medium at full width and depth (24 + 24 layers of
               1024): frames [4, 1500, 1024] and tokens [4, 2048]; flash
               24 times (the decoder's causal self-attention), the encoder
               and cross-attention on ``plain_attention``, 0 launches for
               a 1,024-token decoder; bf16 and f32 against
               ``force="torch"``; 31 greedy steps against memory filled
               from ``encode``; ``serve.main`` (zero memory, as the
               reference's launcher); teacher-forced decode = prefill
  serve_vlm    phi-3-vision-4.2b at full width and depth (32 x 3072, head
               dim 96): patches [4, 576, 3072] + tokens [4, 3520]; flash
               32 times at head dim 96 (the route reported), bf16 and f32
               against ``force="torch"``; ``serve.main``
  train        training (``repro_torch.train``): (a) ``run_training`` of
               tinyllama-1.1b at full width and depth (22 x 2048, bf16,
               seeded weights), 3 steps of 4 x 4,096 tokens in 2
               microbatches (train_4k's batch of 256 cut to 4), AdamW
               with f32 masters, per-layer remat, one checkpoint save:
               finite losses, flash launched 22 x 2 x 2 times a step
               (each layer's forward and its recompute, per microbatch),
               ms per step, tokens/s, peak memory, the save's seconds and
               bytes (free disk checked first), the device idle share of
               one step; (b) one microbatch of (a)'s first batch through
               ``train_loss`` and its gradient, kernel route against
               ``force="torch"`` (loss, gradient norm, each layer's
               attention projection gradients) beside the floor (the
               plain run at flash block 256), f32 at 4 layers within
               1e-4 relative, and the flash Function's dq, dk, dv
               ``torch.equal`` to the blocked plain version's at
               [2, 4096, 32, 64]; (c) mamba2-780m at full width, 8 of its
               48 layers, 2 x 4,096, 2 steps: ssd_scan 16 calls a step on
               the tensor-core route, the same comparison (floor: half
               the SSD chunk) and the SSD Function's gradients
               ``torch.equal`` at the path shape; (d) smoke-size
               qwen2-1.5b, 8 steps against 4 + a crash at step 6 +
               resume: the losses of steps 4-7 equal; (e)
               ``python -m repro_torch.launch.train --arch tinyllama-1.1b
               --reduced --steps 4`` prints its ``done:`` line (a child
               process beside (d)), and ``examples/torch_serve_demo.py``
               and ``examples/torch_train_smoke.py`` (crash at step 20,
               resume from 20, the loss falls) in two more; (f) data
               parallel training (``train.dp``) of (a)'s model on a
               (pod, data) = (2, 2) mesh of the card, (a)'s batch one
               sequence a shard, 3 steps with int8 error-feedback
               cross-pod compression: finite losses, flash 22 x 2 x 4 a
               step, ms a step, tokens/s, peak memory, per-pod residuals
               that differ after step 1, the idle share of a step, the
               device ms of a pod's ``pmean`` and of the compressed
               reduction (device-only traces on one shard's gradient)
               against their byte bounds, and one step with the kernels
               against ``force="torch"`` (loss, pod 0's pre-compression
               gradient norm and attention gradients in (b)'s bands,
               beside the floor); (g) the reference's compressed toy
               (``tests/test_dp_compressed.py``) on a (2, 4) mesh, 150
               steps: final loss under 0.01 and within 0.01 of the
               uncompressed run; (h) smoke-size moonshot-v1-16b-a3b (2
               layers, f32) trained under ``use_rules`` with 2 dispatch
               shards: loss, aux and gradients with per-layer remat
               (whose recompute runs on autograd's device thread) within
               1e-5 relative of the run without remat, and aux not the
               one-shard run's
  roofline     host only: ``utils/cost.py``'s FLOPs and HBM bytes of the
               4 x 4,096 bf16 prefills of ``serve`` and ``serve_ssm`` on
               one card, their bound at the H100's datasheet peaks
               (``launch/roofline.H100``), and the wall time those phases
               measured as a share of it

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
import gc
import json
import math
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
#: the campaign's and the EASY campaign's main runs: the first 5,000 jobs
#: of their 10,000-job streams (cut from all 10,000 for the script's
#: time: the card's host ran 1.0-1.9x slower from one call to the next)
CAMPAIGN_RUN_J = 5_000
#: the twin placer's prefix of the campaign stream (its radix twin takes
#: ~9 ms a step: the whole stream took 84-105 s of the script)
CAMPAIGN_TWIN_J = 2_000


#: a file that also takes every line ``emit`` prints (``--log``)
LOG = []
#: results a later phase compares with: the campaign phase's kernel run
KEPT: dict = {}


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
    ``fn`` makes, from a profiler trace of the device alone (None if the
    trace is empty); with ``count``, also the number of those device
    operations.  Host events would give the same device operations with
    three times the events to read back, at about 0.3 ms an event."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
               (1, 100, 70, 4, 2, 64), (1, 256, 256, 4, 4, 96),
               (2, 128, 384, 4, 2, 96), (1, 100, 70, 2, 1, 96))
#: phi-3-vision's prefill of 576 patches + 3,520 tokens: head dim 96
FLASH_VLM = (4, 4096, 4096, 32, 32, 96)
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
    2 hd (S = Q K^T) + 4 hd' (P V with P split in two, at hd' = 128 for
    head dim 96, whose V tile is padded) operations."""
    b, sq, sk, h, kv, hd = shape
    rep, rows = h // kv, sq * h // kv
    keys = 0
    for row0 in range(0, rows, 64):
        end = min(sk, (min(row0 + 64, rows) - 1) // rep + 1) if causal else sk
        keys += -(-end // 64) * 64
    return (2 * hd + 4 * (128 if hd == 96 else hd)) * 64 * keys * b * kv


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
                want = ("tensor-core" if dtype == torch.bfloat16
                        and shape[-1] in (64, 96, 128) else "f32-core")
                check(flash_attention_cuda.last_route == want,
                      f"{shape} {dtype} took the "
                      f"{flash_attention_cuda.last_route} route, not {want}")
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

    # head dim 96 at phi-3-vision's prefill shape, and its f32 route
    res["hd96"] = _flash_hd96(compare, gen)

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


def _flash_hd96(compare, gen) -> dict:
    """Head dim 96 at phi-3-vision's path shape (``FLASH_VLM``, bf16,
    causal): the tensor-core route within the bands, its times, bound and
    ``F.scaled_dot_product_attention``; the same shape in f32 on the
    f32-core route."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_cuda)
    q, k, v, _, _ = compare(FLASH_VLM, torch.float32, True, 512)
    check(flash_attention_cuda.last_route == "f32-core",
          "f32 hd 96 inputs take the f32-core kernel")
    f32_fn = lambda: flash_attention_cuda(q, k, v, causal=True)  # noqa: E731
    f32_us = cuda_ms(f32_fn, 3, 1) * 1e3
    nb32, ops32 = _attention_work(FLASH_VLM, True, 4)
    del q, k, v
    q, k, v, out, err = compare(FLASH_VLM, torch.bfloat16, True, 512)
    route = flash_attention_cuda.last_route
    check(route == "tensor-core", f"bf16 hd 96 took the {route} route")
    fn = lambda: flash_attention_cuda(q, k, v, causal=True)  # noqa: E731
    lib = _sdpa(q, k, v, True)
    lib_err = float((lib().transpose(1, 2).float() - out.float()).abs().max())
    check(lib_err <= FLASH_ATOL["bfloat16"],
          f"SDPA at hd 96 computes the same attention ({lib_err})")
    nbytes, ops = _attention_work(FLASH_VLM, True, 2)
    res = dict(shape=list(FLASH_VLM), dtype="bfloat16", causal=True,
               route=route, max_abs_err=err,
               kernel_us=cuda_ms(fn, 10) * 1e3,
               kernel_device_us=_device_us_per_call(fn, ("flash_fwd",), 5),
               plain_us=cuda_ms(lambda: flash_attention(
                   q, k, v, causal=True, block_q=512, block_k=512,
                   force="torch"), 2, warmup=1) * 1e3,
               library_us=cuda_ms(lib, 10) * 1e3, library_max_abs_diff=lib_err,
               issued_floor_ms=_flash_issued(FLASH_VLM, True)
               / BF16_TENSOR_OPS_PER_S * 1e3,
               f32_kernel_us=f32_us,
               f32_bound_ms=_bound(nb32, ops32, VECTOR_OPS_PER_S)["bound_ms"])
    res.update(_bound(nbytes, ops, BF16_TENSOR_OPS_PER_S))
    return res


#: the mamba2-780m prefill's scan: b, l, h, g, p, n, chunk (x [4, 4096,
#: 48, 64] seen as 192 head rows, B/C [4, 4096, 1, 128], 16 chunks)
SSD_PATH = (4, 4096, 48, 1, 64, 128, 256)
#: the jamba-v0.1-52b prefill's scan (x [2, 4096, 128, 64], B/C
#: [2, 4096, 1, 16], 16 chunks)
SSD_JAMBA = (2, 4096, 128, 1, 64, 16, 256)
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

    # Jamba's shape: state 16 (zero-padded to the 64 x 64 tiles), 128
    # heads of 64, bf16 model-layout views
    x, dt, dA, B, C = _ssd_inputs(SSD_JAMBA, torch.bfloat16, gen)
    fn = lambda: ssd_scan_cuda(x, dt, dA, B, C, chunk=256)  # noqa: E731
    y, s = fn()
    jamba_route = ssd_scan_cuda.last_route
    torch.cuda.synchronize()
    check(jamba_route == "tensor-core", f"bf16 Jamba inputs took the "
          f"{jamba_route} route")
    plain = lambda: ssd_chunked_dA(x, dt, dA, B, C, 256)  # noqa: E731
    py, ps = plain()
    jamba = _ssd_check("Jamba bf16", y, s, py, ps, SSD_REL)
    del py, ps
    nbytes, ops = _ssd_work(SSD_JAMBA, 2)
    launches = _device_us_by_kernel(fn, ("ssd_",), 10)
    jamba.update(shape=list(SSD_JAMBA), route=jamba_route,
                 kernel_us=cuda_ms(fn, 20) * 1e3,
                 kernel_device_us=sum(launches.values()) if launches else None,
                 launch_device_us=launches,
                 plain_us=cuda_ms(plain, 3, warmup=1) * 1e3,
                 issued_floor_ms=(_ssd_issued(SSD_JAMBA)
                                  / BF16_TENSOR_OPS_PER_S * 1e3),
                 **_bound(nbytes, ops, BF16_TENSOR_OPS_PER_S))
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
        jamba=jamba, cases=rows)
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
              seeds=CAMPAIGN_SEEDS, chunk=None, shards=None,
              easy_eval="batched"):
    """``Scheduler.run`` of the campaign's grid (``paper`` over the K grid
    x seeds, warm start) or of ``policy`` with ``seeds``."""
    from repro_torch.core import FaultConfig, Scheduler
    sched = Scheduler(policy or _policy_of(), seeds=seeds, warm_start=True,
                      faults=None if faults is None else FaultConfig(**faults),
                      placer=placer, device=device, queue=queue,
                      engine=engine, chunk=chunk, shards=shards,
                      easy_eval=easy_eval)
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


def _sync_sites(fn) -> list:
    """Where ``fn()`` makes a host synchronisation, by PyTorch's sync
    debug mode: one (file, line) a synchronisation."""
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the message of each synchronisation (not the one-time notice that
    # the mode is a prototype)
    return [(os.path.basename(c.filename), c.lineno) for c in caught
            if "called a synchronizing" in str(c.message)]


def _sync_count(fn):
    """Number of host synchronisations ``fn()`` makes, counted by
    PyTorch's sync debug mode."""
    return len(_sync_sites(fn))


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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    w = _prefix(make_stream_workload(JSCC_SYSTEMS, CAMPAIGN_J, "poisson",
                                     rate=0.5, seed=0), CAMPAIGN_RUN_J)
    J, B = CAMPAIGN_RUN_J, len(CAMPAIGN_KS) * len(CAMPAIGN_SEEDS)

    # the main path: every count to 0 just before, read just after
    kth_free_cuda.launches = 0
    full, t_full, _ = _timed_campaign(w)
    n_main = kth_free_cuda.launches
    _count(counters, "kth_free", "campaign", n_main)
    check(n_main == J, f"kth_free launches {n_main} != J={J}")
    KEPT["campaign"] = (w, full, t_full)

    tot, t_tot, n_tot = _timed_campaign(w, totals_only=True)
    check(n_tot == J, f"totals_only launches {n_tot} != J={J}")
    # the twin placer on the stream's prefix, against the kernel on the
    # same prefix on every field and the whole run on its per-job values
    # (a job's placement reads only the jobs before it)
    wt = _prefix(w, CAMPAIGN_TWIN_J)
    twin, t_twin, n_twin = _timed_campaign(wt, placer="torch")
    check(n_twin == 0, "placer='torch' must not launch the kernel")
    part = _campaign(wt)
    for f in ("system", "start", "finish", "wait", "energy", "runtime",
              "total_energy", "total_wait", "slowdown_sum", "makespan",
              "busy", "idle_energy", "C_tab", "T_tab", "runs"):
        check(torch.equal(getattr(part, f), getattr(twin, f)),
              f"kernel and twin placers differ on {f}")
    for f in ("system", "start", "finish", "wait", "energy", "runtime"):
        check(torch.equal(getattr(full, f)[..., :CAMPAIGN_TWIN_J],
                          getattr(twin, f)),
              f"the twin placer's prefix differs from the whole run on {f}")
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
               twin_placer_jobs=CAMPAIGN_TWIN_J,
               ms_per_step_twin_placer=t_twin / CAMPAIGN_TWIN_J * 1e3,
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


def _cross_cases():
    """``cross_device``'s runs: (name, workload, ``_campaign`` keywords):
    the first 1,000 jobs of the campaign (full path and ``totals_only``),
    the first 500 of the EASY stream (both paths), and the first
    EVENT_TWIN_J jobs of the event runs (a) and (d)."""
    from repro_torch.core import JSCC_SYSTEMS
    from repro_torch.data import make_stream_workload
    w = _prefix(make_stream_workload(JSCC_SYSTEMS, CAMPAIGN_J, "poisson",
                                     rate=0.5, seed=0), 1000)
    we = _prefix(_easy_stream(), 500)
    out = [(f"fcfs.{t}", w, dict(totals_only=t)) for t in (False, True)]
    out += [(f"easy.{t}", we, dict(totals_only=t, queue=EASY_QUEUE))
            for t in (False, True)]
    out += [("fcfs_retries", _prefix(_event_stream(), EVENT_TWIN_J),
             dict(engine="events", queue=EVENT_FCFS)),
            ("cons_capped", _prefix(_cap_stream(), EVENT_TWIN_J),
             dict(policy=_cap_policy(), faults=None, seeds=0))]
    return out


def _tensor_fields(res) -> dict:
    """A result's tensor fields on the CPU (None where absent)."""
    import dataclasses
    import torch
    out = {}
    for f in dataclasses.fields(res):
        v = getattr(res, f.name)
        if v is None or torch.is_tensor(v):
            out[f.name] = None if v is None else v.cpu()
    return out


def cross_part(tmp: str) -> None:
    """The host's side of ``cross_device`` and ``mirror``, in a process of
    its own (``KID_GROUPS``) started after the build, two CPU threads:
    the port's CPU runs of ``_cross_cases`` and of every ``MIRROR_RUNS``
    grid, and the float64 mirror ``simulate_py`` of every run and K,
    saved to ``tmp/cross.pt``."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import simulate_py
    torch.set_num_threads(2)
    out = {}
    for name, w, kw in _cross_cases():
        out[name] = _tensor_fields(_campaign(w, device="cpu", **kw))
    w = _mirror_stream()
    for name, (fields, kw) in MIRROR_RUNS.items():
        cfg0, sched = _mirror_sched(fields)
        out[f"mirror.{name}.cpu"] = _tensor_fields(sched("cpu").run(w))
        for k in CAMPAIGN_KS:
            ref = simulate_py(w, dataclasses.replace(cfg0, k=float(k)), **kw)
            out[f"mirror.{name}.{k}"] = {
                f: torch.as_tensor(np.asarray(v)) for f, v in ref.items()}
    torch.save(out, os.path.join(tmp, "cross.pt"))


def _cross_results() -> dict:
    """``cross_part``'s results (joining the child, starting it if no
    earlier phase did), loaded once."""
    import torch
    if "cross" not in KEPT:
        _service_start(("cross_device",))
        try:
            _service_join("cross")
            KEPT["cross"] = torch.load(os.path.join(_kid_dir("cross"),
                                                    "cross.pt"))
        finally:
            _service_stop(KID_GROUPS["cross_device"])
    return KEPT["cross"]


def _on_card(fields: dict, like):
    """A saved result's fields as a namespace on ``like``'s device."""
    import types
    return types.SimpleNamespace(**{
        f: None if v is None else v.to(like.device)
        for f, v in fields.items()})


def phase_cross_device() -> None:
    """The CPU (twin) runs of ``cross_part`` against the card (kernel) on
    the same inputs: the first 1,000 jobs of the campaign, 500 of the EASY
    stream and EVENT_TWIN_J of the event runs (a) and (d), placements and
    per-job values exact, reductions over jobs within rtol 1e-6 (torch.sum
    adds in another order on each device)."""
    cpu_runs = _cross_results()
    banded = ("total_energy", "total_wait", "slowdown_sum")
    fcfs = ("system", "tier", "nodes", "start", "finish", "wait", "energy",
            "runtime", "C_tab", "T_tab", "runs", "busy", "makespan",
            "max_wait", "idle_energy") + banded
    for name, w, kw in _cross_cases():
        gpu = _campaign(w, **kw)
        cpu = _on_card(cpu_runs[name], gpu.makespan)
        totals = kw.get("totals_only", False)
        fields = (fcfs if name.startswith("fcfs.") else
                  EASY_FIELDS if name.startswith("easy.") else EVENT_FIELDS)
        worst = _same(cpu, gpu, fields, () if totals else banded,
                      f"cpu/cuda {name}")
        line = dict(jobs=len(w.prog),
                    exact="all" if totals else "all but " + ",".join(banded),
                    worst_rel_reduction=worst)
        if name.startswith("fcfs."):
            line["totals_only"] = totals
        elif name.startswith("easy."):
            line.update(queue=EASY_QUEUE, totals_only=totals,
                        n_backfilled=gpu.n_backfilled.flatten().tolist())
        else:
            line.update(run=name,
                        peak_power=gpu.peak_power.flatten().tolist())
        emit("cross_device", **line)


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
    w = _prefix(_easy_stream(), CAMPAIGN_RUN_J)
    J, W, B = CAMPAIGN_RUN_J, EASY_WINDOW, len(CAMPAIGN_KS) * len(CAMPAIGN_SEEDS)
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
#: steps and each run's twins as many again; 500 until PR 26); the
#: example's capped conservative campaign
#: (``examples/multi_cluster_campaign.py``), its ``totals_only`` and
#: uncapped twins, and ``cross_device``, on the first EVENT_TWIN_J jobs
EVENT_J = 250
EVENT_TWIN_J = 250
EVENT_FCFS = f"fcfs:window={EASY_WINDOW}"
CONS_QUEUE = f"conservative:window={EASY_WINDOW}"
STRAGGLERS = dict(straggler_prob=0.05)
CAPS = (45e3, 52e3, 60e3, float("inf"))
#: the capped campaign's depth, cut from the example's 1,000 jobs to its
#: twins' EVENT_TWIN_J for the script's time
CAP_J = EVENT_TWIN_J
FCFS_FIELDS = ("system", "tier", "nodes", "start", "finish", "wait",
               "energy", "runtime", "total_energy", "makespan", "total_wait",
               "max_wait", "slowdown_sum", "busy", "C_tab", "T_tab", "runs",
               "idle_energy")
EVENT_FIELDS = EASY_FIELDS + ("peak_power", "capped_delay")


def _event_stream(n=EVENT_J):
    """The campaign phase's Poisson NPB stream, its first ``n`` jobs."""
    from repro_torch.core import JSCC_SYSTEMS
    from repro_torch.data import make_stream_workload
    return _prefix(make_stream_workload(JSCC_SYSTEMS, CAMPAIGN_J, "poisson",
                                        rate=0.5, seed=0), n)


def _cap_stream():
    """The example's capped campaign's diurnal stream of 1,000 jobs, its
    first CAP_J."""
    from repro_torch.core import JSCC_SYSTEMS
    from repro_torch.data import make_stream_workload
    return _prefix(make_stream_workload(JSCC_SYSTEMS, 1_000,
                                        arrival="diurnal", rate=0.8, seed=3),
                   CAP_J)


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
    core, event-driven EASY, the example's capped conservative campaign;
    the twins of (a) and (d), the reference ablation's queue comparison
    and the DVFS lattice run in the ``event`` child and are checked by
    ``_event_finish``."""
    import numpy as np
    import torch
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
    put("cons_capped", dict(
        stats, caps=list(CAPS), peak_power=peak.tolist(),
        makespan=mk.tolist(), capped_delay=d.capped_delay.cpu().tolist(),
        idle_energy=d.idle_energy.cpu().tolist(),
        n_backfilled=d.n_backfilled.cpu().tolist()))

    # (a)'s and (d)'s twins, (e) and (f): no times, so they run in the
    # ``event`` child beside ``cross_device``; the checks wait for it
    EVENT_HELD.update(a=a, d=d, put=put)
    return out


def event_part(tmp: str) -> None:
    """``event_campaign``'s untimed runs on the card, saved to
    ``tmp/event.pt``: (a)'s sort-placer and ``totals_only`` twins (and the
    kernel's launches in the first), (d)'s ``totals_only`` and uncapped
    twins (tensor fields, on the CPU), (e) the reference ablation's mean
    waits and (f) the DVFS lattice.  Runs in a process of its own
    (``KID_GROUPS``)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import JSCC_SYSTEMS, Scheduler, make_npb_workload
    from repro_torch.core.policy import make_policy
    from repro_torch.data import (load_swf, make_stream_workload, swf_lines,
                                  synthetic_swf_arrays, workload_from_trace)
    from repro_torch.kernels.kth_free import kth_free_cuda

    def fields(res):
        """The result's tensor fields on the CPU (None where absent)."""
        out = {}
        for f in dataclasses.fields(res):
            v = getattr(res, f.name)
            if v is None or torch.is_tensor(v):
                out[f.name] = None if v is None else v.cpu()
        return out
    out = {}
    w = _event_stream()
    kw = dict(engine="events", queue=EVENT_FCFS)
    kth_free_cuda.launches = 0
    out["fcfs_retries.sort"] = fields(_campaign(w, placer="sort", **kw))
    out["sort_launches"] = kth_free_cuda.launches
    out["fcfs_retries.totals_only"] = fields(_campaign(w, totals_only=True,
                                                       **kw))
    wc = _cap_stream()
    out["cons_capped.totals_only"] = fields(_campaign(
        wc, policy=_cap_policy(), faults=None, seeds=0, totals_only=True))
    out["cons_capped.uncapped"] = fields(_campaign(
        wc, policy=make_policy("conservative", k=0.10), faults=None,
        seeds=0, queue=CONS_QUEUE))

    # (e) the reference ablation's queue comparison
    streams = {
        "swf": workload_from_trace(load_swf(swf_lines(
            *synthetic_swf_arrays(250, 11))), JSCC_SYSTEMS),
        "diurnal": make_stream_workload(JSCC_SYSTEMS, 300,
                                        arrival="diurnal", rate=0.8, seed=3,
                                        pred_noise=0.05)}
    out["ablation"] = {
        tag: {queue.split(":")[0]: float(Scheduler(
            make_policy("paper", k=0.10), warm_start=True,
            queue=queue).run(ws).mean_wait)
            for queue in ("fcfs", "easy_backfill:window=16",
                          "conservative:window=16")}
        for tag, ws in streams.items()}

    # (f) the DVFS Pareto lattice (``benchmarks/dvfs_pareto.py``): cap x
    # freq_weight x K
    wn = make_npb_workload(JSCC_SYSTEMS, repeats=4)
    scale = float(np.median(wn.C_true) / np.median(wn.T_true))
    caps, fws, ks = (x.ravel() for x in np.meshgrid(
        np.array([45e3, 55e3, 1e30], np.float32),
        scale * np.array([0.0, 0.25, 1.0, 4.0], np.float32),
        np.array([0.10, 0.50], np.float32), indexing="ij"))
    r = Scheduler(make_policy("dvfs_paper", k=ks, freq_weight=fws,
                              power_cap=caps), warm_start=True).run(wn)
    out["dvfs"] = dict(caps=caps.tolist(), peak_power=r.peak_power.cpu(),
                       total_energy=r.total_energy.cpu(),
                       makespan=r.makespan.cpu(),
                       tier_counts=r.tier_counts.cpu())
    torch.save(out, os.path.join(tmp, "event.pt"))


#: ``event_campaign``'s kernel runs (a) and (d) and its ``put``, held until
#: the ``event`` child's twins are checked against them
EVENT_HELD: dict = {}


def _event_finish() -> None:
    """Join the ``event`` child (starting it if no earlier phase did) and
    run ``event_campaign``'s checks on its runs: (a)'s sort placer
    launches nothing and equals the kernel run on every field,
    ``totals_only`` keeps (a)'s and (d)'s totals, (d)'s uncapped lane
    equals an uncapped run; (e) conservative's mean wait below EASY's on
    both streams; (f) every binding DVFS cap holds.  Emits the (e) and (f)
    lines."""
    import types
    import torch
    if not EVENT_HELD:
        return
    _service_start(("event_campaign",))
    try:
        _service_join("event")
        t = torch.load(os.path.join(_kid_dir("event"), "event.pt"))
    finally:
        _service_stop(KID_GROUPS["event_campaign"])
    a, d, put = EVENT_HELD.pop("a"), EVENT_HELD.pop("d"), EVENT_HELD.pop("put")

    def res(name):
        return types.SimpleNamespace(**{
            f: None if v is None else v.to(a.makespan.device)
            for f, v in t[name].items()})
    check(t["sort_launches"] == 0, "placer='sort' launched the kernel")
    _same(a, res("fcfs_retries.sort"), EVENT_FIELDS, (),
          "fcfs_retries kernel/sort")
    _totals_agree(a, res("fcfs_retries.totals_only"), "fcfs_retries")
    _totals_agree(d, res("cons_capped.totals_only"), "cons_capped")
    unc = res("cons_capped.uncapped")
    for f in EVENT_FIELDS:
        check(torch.equal(getattr(d, f)[-1], getattr(unc, f)),
              f"inf-cap lane != uncapped run on {f}")
    for tag, waits in t["ablation"].items():
        check(waits["conservative"] < waits["easy_backfill"],
              f"{tag}: conservative's mean wait is not below EASY's "
              f"{waits}")
    put("ablation_mean_wait", t["ablation"])
    dv = t["dvfs"]
    pk = dv["peak_power"].numpy()
    for i, cap in enumerate(dv["caps"]):
        if cap < 1e29:
            check(pk[i] <= cap * (1 + 1e-5), f"DVFS peak {pk[i]} > {cap}")
    put("dvfs_lattice", dict(
        points=len(dv["caps"]), peak_power=pk.tolist(),
        total_energy=dv["total_energy"].tolist(),
        makespan=dv["makespan"].tolist(),
        tier_counts=dv["tier_counts"].tolist()))


#: campaign scale (a): each core's chunked run against its monolithic
#: run, at chunk sizes that divide none of the runs
SCALE_CHUNKS = {"fcfs": 4093, "easy": 97, "events": 129, "cons_capped": 129}
SCALE_EASY_J = 1_000
SCALE_EVENT_J = 200
#: (c): the reference's million-job configuration
#: (``tests/test_sharded_campaign.py:157-181``) on a 64-lane grid, its
#: J cut from 10^6 to 3 x 10^4 for the script's time (at 5,000 and
#: 15,000 the peak grew 3.45 MB, over the [64, 10^4] array of that
#: gate; from 10^4 on it is flat: PERF.md, PR 26)
SCALE_JS = (10_000, 30_000)
SCALE_CHUNK = 4096
SCALE_KS = 16
SCALE_SEEDS = (0, 1, 2, 3)


def _small_systems():
    """The two small systems of the reference's million-job campaign."""
    from repro_torch.core.systems import ComputeSystem
    return (
        ComputeSystem(name="alpha", n_nodes=8, cores_per_node=64,
                      peak_flops_node=2e12, mem_bw_node=200e9,
                      net_bw_node=10e9, disk_bw_node=2e9, idle_w=100.0,
                      cpu_w=200.0, net_w=20.0, disk_w=10.0, efficiency=0.5),
        ComputeSystem(name="beta", n_nodes=12, cores_per_node=48,
                      peak_flops_node=1.2e12, mem_bw_node=150e9,
                      net_bw_node=8e9, disk_bw_node=1.5e9, idle_w=80.0,
                      cpu_w=160.0, net_w=15.0, disk_w=8.0, efficiency=0.55))


def _fields(res) -> tuple:
    """Every tensor field of a result (totals, tables, per-job)."""
    return tuple(res.to_dict())


def _kernel_count(fn) -> int:
    """CUDA kernels, memsets and copies one call of ``fn`` runs, from a
    trace of the device alone (lighter than ``_launches_per_step``'s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


def _chunk_launches(w, steps, chunk, big_chunk, **kw) -> dict:
    """Device launches of a short ``totals_only`` run of ``w`` (``steps``
    steps): monolithic, as one chunk (``chunk=steps``) and in chunks of
    ``chunk``.  From them: the launches a chunked step adds (one chunk
    against the monolithic run, per step), the launches each further
    chunk adds, and the launches per step at ``big_chunk`` those two
    predict.  (On the full path FCFS and EASY also redraw every job's
    fault factor once at the end.)"""
    n = {tag: _kernel_count(lambda: _campaign(w, chunk=ck, totals_only=True,
                                              **kw))
         for tag, ck in (("mono", None), ("one", steps),
                         ("chunked", chunk))}
    if not n["mono"]:
        return dict(profiled_steps=steps, launches=None)
    n_chunks = -(-steps // chunk)
    per_step_extra = (n["one"] - n["mono"]) / steps
    per_chunk_extra = (n["chunked"] - n["one"]) / (n_chunks - 1)
    return dict(profiled_steps=steps, profiled_chunk=chunk,
                launches_per_step_mono=n["mono"] / steps,
                launches_per_step_one_chunk=n["one"] / steps,
                launches_per_step_chunked=n["chunked"] / steps,
                extra_launches_per_step=per_step_extra,
                extra_launches_per_chunk=per_chunk_extra,
                launches_per_step_at_chunk=(n["mono"] / steps
                                            + per_step_extra
                                            + per_chunk_extra / big_chunk))


def _chunked_run(name, w, steps, calls, counters, *, mono=None,
                 totals=False, **kw) -> dict:
    """One core chunked against monolithic on every field (and, with
    ``totals``, the ``totals_only`` pair); the chunked run is a main path
    of the kth_free kernel (``calls`` launches a step)."""
    from repro_torch.kernels.kth_free import kth_free_cuda
    chunk = SCALE_CHUNKS[name]
    if mono is None:
        mono, t_mono, _ = _timed_campaign(w, **kw)
    else:
        mono, t_mono = mono
    kth_free_cuda.launches = 0
    got, t_chunk, _ = _timed_campaign(w, chunk=chunk, **kw)
    n_main = kth_free_cuda.launches
    _count(counters, "kth_free", f"campaign_scale.{name}", n_main)
    check(n_main == steps * calls, f"{name}: chunked kth_free launches "
          f"{n_main} != {calls} x {steps} steps")
    _same(mono, got, _fields(mono), (), f"{name}: chunked/monolithic")
    out = dict(jobs=len(w.prog), lanes=got.makespan.numel(), steps=steps,
               chunk=chunk, seconds_mono=t_mono, seconds_chunked=t_chunk,
               ms_per_step_mono=t_mono / steps * 1e3,
               ms_per_step_chunked=t_chunk / steps * 1e3,
               kth_free_launches=n_main, bit_equal_fields=len(_fields(mono)))
    if totals:
        tm, t_tm, _ = _timed_campaign(w, totals_only=True, **kw)
        tc, t_tc, _ = _timed_campaign(w, totals_only=True, chunk=chunk, **kw)
        _same(tm, tc, _fields(tm), (), f"{name}: chunked/monolithic totals")
        out.update(seconds_totals_mono=t_tm, seconds_totals_chunked=t_tc,
                   bit_equal_fields_totals=len(_fields(tm)))
    return out


def _chunk_costs(name, w, small, **kw) -> dict:
    """Launches and host syncs of one core, chunked against monolithic,
    on short prefixes: ``small`` = (prefix jobs, its steps, chunk).  The
    syncs: ``totals_only`` monolithic on n jobs and chunked on n and 2n,
    and the full path chunked on 2n."""
    n_small, small_steps, small_chunk = small
    t0 = time.perf_counter()
    out = _chunk_launches(_prefix(w, n_small), small_steps, small_chunk,
                          SCALE_CHUNKS[name], **kw)
    sync = lambda n, ck, tot: _sync_count(  # noqa: E731
        lambda: _campaign(_prefix(w, n), chunk=ck, totals_only=tot, **kw))
    syncs = {"mono_totals": sync(n_small, None, True),
             "chunked_totals": [sync(n, small_chunk, True)
                                for n in (n_small, 2 * n_small)],
             "chunked_full": sync(2 * n_small, small_chunk, False)}
    check(syncs["chunked_totals"] == [syncs["mono_totals"]] * 2,
          f"{name}: totals_only host syncs grow with the chunks: {syncs}")
    out.update(host_syncs=syncs, prefix_jobs=[n_small, 2 * n_small],
               seconds=time.perf_counter() - t0)
    return out


def _scale_run(w, chunk):
    """Part (c): ``ucb`` over 16 K x 4 seeds, warm start, ``totals_only``:
    wall seconds and the peak memory the run allocates above what was
    allocated before it."""
    import numpy as np
    import torch
    from repro_torch.core import Scheduler, make_policy
    ks = np.linspace(0.0, 0.35, SCALE_KS).astype(np.float32)
    sched = Scheduler(make_policy("ucb", k=ks), warm_start=True,
                      seeds=list(SCALE_SEEDS), chunk=chunk)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sched.run(w, totals_only=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return res, seconds, torch.cuda.max_memory_allocated() - base


def _suppz_round(device, path) -> list:
    """Five NPB programs through ``SuppzFrontend``: first submissions,
    measured completions, resubmissions with admin and automatic K."""
    import dataclasses
    from repro_torch.core.suppz import Submission, SuppzFrontend
    systems = ["KNL", "Broadwell", "Skylake", "CascadeLake"]
    prof = {"KNL": (1.0, 150.0), "Broadwell": (2.8, 130.0),
            "Skylake": (1.7, 76.0), "CascadeLake": (1.4, 80.0)}
    fe = SuppzFrontend(path, systems, device=device)
    out = []
    for i, prog in enumerate(("BT", "EP", "IS", "LU", "SP")):
        exe = f"npb-{prog}".encode()
        out.append(fe.submit(Submission(exe, np_=16 * (i + 1),
                                        t_max=300.0 + 50 * i),
                             availability=[float((i + s) % 4)
                                           for s in range(4)]))
        for j, (name, (c, t)) in enumerate(prof.items()):
            fe.report_completion(exe, name, c=c * (1 + 0.1 * i),
                                 t=t * (1 + 0.05 * ((i + j) % 3)))
        out.append(fe.submit(Submission(exe, np_=16, t_max=90.0 + i,
                                        k=0.05 * i)))
        out.append(fe.submit(Submission(exe, np_=16, t_max=140.0)))
    return [dataclasses.asdict(d) for d in out]


def scale_part() -> dict:
    """Part (c) of ``campaign_scale``, run in a process of its own beside
    the rest of the phase (its peak memory is that process's alone): the
    reference's million-job configuration at J = SCALE_JS, chunked, and
    at the first of them monolithic."""
    import torch
    from repro_torch.data import synthetic_swf_arrays, workload_from_arrays
    scale = {}
    for J in SCALE_JS:
        ws = workload_from_arrays(*synthetic_swf_arrays(J, seed=11),
                                  _small_systems())
        res, seconds, peak = _scale_run(ws, SCALE_CHUNK)
        check(bool(torch.isfinite(res.total_energy).all())
              and bool((res.total_energy > 0).all()), f"J={J}: totals")
        scale[str(J)] = dict(seconds=seconds, peak_bytes=peak,
                             ms_per_step=seconds / J * 1e3,
                             jobs_per_s=J * res.total_energy.numel() / seconds,
                             lanes=res.total_energy.numel(),
                             energy0=float(res.total_energy.flatten()[0]))
        if J == SCALE_JS[0]:
            mono, mono_s, mono_peak = _scale_run(ws, None)
            check(torch.equal(mono.total_energy, res.total_energy)
                  and torch.equal(mono.makespan, res.makespan),
                  "scale: chunked totals != monolithic")
            scale[f"mono_{J}"] = dict(seconds=mono_s, peak_bytes=mono_peak,
                                      ms_per_step=mono_s / J * 1e3)
    lo, hi = (scale[str(J)] for J in SCALE_JS)
    growth = hi["peak_bytes"] - lo["peak_bytes"]
    limit = lo["lanes"] * (SCALE_JS[1] - SCALE_JS[0]) * 4
    check(lo["lanes"] == 64, f"scale grid has {lo['lanes']} lanes")
    check(growth < limit, f"peak memory grows {growth} B from J = "
          f"{SCALE_JS[0]} to {SCALE_JS[1]}, not under one [64, "
          f"{SCALE_JS[1] - SCALE_JS[0]}] f32 array ({limit} B)")
    return dict(scale, peak_growth_bytes=growth, limit_bytes=limit,
                chunk=SCALE_CHUNK)


#: ``campaign_scale``'s children (c) and (d): (log directory, {name:
#: (start time, output files, process)}), started by ``_scale_start``
SCALE_KIDS: dict = {}


def _scale_start():
    """Start ``campaign_scale``'s children (c) and (d) once, their output
    to files (a full pipe never stalls them): from ``event_campaign`` on
    in a whole run, so that the million-job configuration runs beside
    it; ``campaign_scale`` joins them."""
    import tempfile
    if not SCALE_KIDS:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        children = {
            "scale": [sys.executable, "-c", "import json, chip_smoke; "
                      "print(json.dumps(chip_smoke.scale_part()))"],
            "torch_quickstart.py": [sys.executable,
                                    "examples/torch_quickstart.py"],
            "torch_multi_cluster_campaign.py": [
                sys.executable, "examples/torch_multi_cluster_campaign.py",
                "--jobs", "4", "--sim-jobs", "500"],
        }
        logs = tempfile.TemporaryDirectory()
        procs = {}
        for name, argv in children.items():
            files = [open(os.path.join(logs.name, f"{name}.{x}"), "w+")
                     for x in ("out", "err")]
            procs[name] = (time.perf_counter(), files, subprocess.Popen(
                argv, cwd=ROOT, env=env, text=True, stdout=files[0],
                stderr=files[1]))
        SCALE_KIDS.update(logs=logs, procs=procs)
    return SCALE_KIDS["logs"], SCALE_KIDS["procs"]


def phase_campaign_scale(counters: dict) -> dict:
    """Campaign scale on the card.  (a) each core chunked against its
    monolithic run, bit for bit on every field: FCFS on the campaign
    phase's own 5,000-job kernel run (chunk 4,093), EASY window 16 on
    the first 1,000 jobs of the EASY stream (chunk 97, full and
    ``totals_only``), the event core's FCFS with failure re-queue on the
    first 200 jobs of the event stream (chunk 129), the capped
    conservative grid (4 caps) on the first 200 jobs of the cap stream
    (chunk 129, full and ``totals_only``).  (b) ``shards="auto"`` and
    ``shards=1`` equal the unsharded run on 2,000 FCFS jobs; one shard
    more than the devices raises ``ValueError``.  (c) the reference's
    million-job configuration (two small systems, ``ucb``, warm,
    ``totals_only``, chunk 4,096) on 16 K x 4 seeds = 64 lanes at J =
    10,000 and 30,000 (cut from 10^6: a step takes over a millisecond, so
    10^6 steps would outlast the script): peak memory grows by less than
    one [64, 20,000] f32 array (``scale_part``).  (d)
    ``examples/torch_quickstart.py`` and
    ``examples/torch_multi_cluster_campaign.py --jobs 4 --sim-jobs 500``
    exit 0 on the card; a SUPPZ round decides as on the CPU.  (c) and
    (d) run in processes of their own (``_scale_start``), started with
    ``event_campaign`` in a whole run, beside it, (a), (b) and, last, the
    launches and host syncs chunked against monolithic on short prefixes
    (every step is host dispatch, and the card is idle most of the
    time)."""
    import tempfile
    import torch
    from repro_torch.core import events
    out = {}
    _, procs = _scale_start()
    try:
        # the sync detector's first use in a process counts one more
        probe = _sync_count(lambda: torch.ones(1, device="cuda").sum()
                            .item())
        check(probe >= 1, "sync debug mode reports no sync for .item()")

        # (a) chunked against monolithic
        if "campaign" in KEPT:
            w, full, t_full = KEPT["campaign"]
            mono = (full, t_full)
        else:
            from repro_torch.core import JSCC_SYSTEMS
            from repro_torch.data import make_stream_workload
            w = _prefix(make_stream_workload(JSCC_SYSTEMS, CAMPAIGN_J,
                                             "poisson", rate=0.5, seed=0),
                        CAMPAIGN_RUN_J)
            mono = None
        we = _prefix(_easy_stream(), SCALE_EASY_J)
        wv = _prefix(_event_stream(), SCALE_EVENT_J)
        wc = _prefix(_cap_stream(), SCALE_EVENT_J)
        pol_v, pol_c = _policy_of(EVENT_FCFS), _cap_policy()
        runs = {  # name: (workload, steps, kth_free calls a step, kwargs,
                  #        the profiled prefix: jobs, steps, chunk)
            "fcfs": (w, CAMPAIGN_RUN_J, 1, {}, (60, 60, 25)),
            "easy": (we, SCALE_EASY_J + EASY_WINDOW, 2,
                     dict(queue=EASY_QUEUE), (60, 60 + EASY_WINDOW, 25)),
            "events": (wv, events.step_count(wv, pol_v, True), 1,
                       dict(engine="events", queue=EVENT_FCFS),
                       (8, events.step_count(_prefix(wv, 8), pol_v, True),
                        25)),
            "cons_capped": (wc, events.step_count(wc, pol_c, False), 1,
                            dict(policy=pol_c, faults=None, seeds=0),
                            (8, events.step_count(_prefix(wc, 8), pol_c,
                                                  False), 15)),
        }
        for name, (wn, steps, calls, kw, _) in runs.items():
            out[name] = _chunked_run(name, wn, steps, calls, counters,
                                     mono=mono if name == "fcfs" else None,
                                     totals=name in ("easy", "cons_capped"),
                                     **kw)

        # (b) sharding on the one card
        t_part = time.perf_counter()
        wb = _prefix(w, 2_000)
        base, t_base, _ = _timed_campaign(wb)
        n_dev = torch.cuda.device_count()
        t_shards = {}
        for shards in ("auto", 1):
            got, t_shards[str(shards)], _ = _timed_campaign(wb, shards=shards)
            _same(base, got, _fields(base), (), f"shards={shards!r}")
        try:
            _campaign(wb, shards=n_dev + 1)
            raised = None
        except ValueError as e:
            raised = str(e)
        check(raised is not None, f"shards={n_dev + 1} on {n_dev} devices "
              "did not raise")
        out["shards"] = dict(devices=n_dev, jobs=2_000, equal=["auto", 1],
                             too_many=n_dev + 1, error=raised,
                             ms_per_step_unsharded=t_base / 2_000 * 1e3,
                             ms_per_step_sharded={k: v / 2_000 * 1e3
                                                  for k, v
                                                  in t_shards.items()},
                             seconds=time.perf_counter() - t_part)
        emit("campaign_scale", run="shards", **out["shards"])

        # launches and host syncs, chunked against monolithic, on prefixes
        for name, (wn, _, _, kw, small) in runs.items():
            out[name].update(_chunk_costs(name, wn, small, **kw))
            emit("campaign_scale", run=f"chunked_{name}", **out[name])

        # (d) a SUPPZ round; then the children's results
        with tempfile.TemporaryDirectory() as tmp:
            on_card = _suppz_round("cuda", os.path.join(tmp, "card.msgpack"))
            on_cpu = _suppz_round("cpu", os.path.join(tmp, "cpu.msgpack"))
        check(on_card == on_cpu, "SUPPZ decides otherwise on the card")
        done = {}
        for name, (t0, (fout, ferr), proc) in procs.items():
            proc.wait(timeout=900)
            fout.seek(0)
            ferr.seek(0)
            check(proc.returncode == 0,
                  f"{name} exited {proc.returncode}: {ferr.read()[-2000:]}")
            done[name] = (time.perf_counter() - t0, fout.read().splitlines())
    finally:
        _scale_stop()
    seconds, lines = done.pop("scale")
    out["scale"] = dict(json.loads(lines[-1]), seconds_wall=seconds)
    emit("campaign_scale", run="scale", **out["scale"])
    out["entry_points"] = dict(
        examples={name: dict(seconds_wall=t, lines=lines)
                  for name, (t, lines) in done.items()},
        suppz_decisions=len(on_card),
        suppz_systems=sorted({d["system"] for d in on_card}))
    emit("campaign_scale", run="entry_points", **out["entry_points"])
    return out


def _scale_stop() -> None:
    """Stop ``campaign_scale``'s children still running; remove their
    files."""
    if SCALE_KIDS:
        for _, files, proc in SCALE_KIDS["procs"].values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            for f in files:
                f.close()
        SCALE_KIDS.pop("logs").cleanup()
        SCALE_KIDS.clear()


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


#: the online service: the CLI's default session capacity (also the
#: length of the campaign stream's prefix it replays), and the fields
#: live == batch compares (the reference's ``tests/test_service.py``
#: tuple)
SERVICE_C = 256
SERVICE_FIELDS = ("system", "start", "finish", "wait", "energy", "runtime",
                  "backfilled", "total_energy", "makespan", "total_wait",
                  "slowdown_sum", "max_wait", "n_backfilled", "peak_power",
                  "idle_energy", "capped_delay", "busy", "C_tab", "T_tab",
                  "runs")
SERVICE_CAP = 45e3
#: the reference CLI docstring's request stream
#: (``src/repro/launch/scheduler_service.py:9-19``)
SERVICE_REQUESTS = (
    {"op": "submit", "prog": "BT", "arrival": 0.0},
    {"op": "submit", "prog": "LU", "arrival": 5.0},
    {"op": "drive", "until": 100.0},
    {"op": "whatif", "prog": "SP"},
    {"op": "checkpoint"},
    {"op": "drain"},
    {"op": "metrics"},
    {"op": "result"})


def _feed(d, w, jobs):
    """The live protocol: submit each job before driving past its
    arrival."""
    for j in jobs:
        d.drive(until=float(w.arrival[j]))
        d.submit(int(w.prog[j]), float(w.arrival[j]))


def _percentiles(us) -> dict:
    import numpy as np
    us = np.asarray(us, np.float64)
    return dict(mean=float(us.mean()), p50=float(np.percentile(us, 50)),
                p99=float(np.percentile(us, 99)), max=float(us.max()),
                n=int(us.size))


def _service_runs():
    """The service phase's seven sessions: (name, workload, queue, faults,
    kth_free launches a live step, power cap)."""
    from repro_torch.core import JSCC_SYSTEMS
    from repro_torch.data import (load_swf, swf_lines, synthetic_swf_arrays,
                                  workload_from_trace)
    poisson = _event_stream(SERVICE_C)
    swf = workload_from_trace(load_swf(swf_lines(
        *synthetic_swf_arrays(250, 11))), JSCC_SYSTEMS)
    return (("fcfs", poisson, EVENT_FCFS, CAMPAIGN_FAULTS, 1, None),
            ("easy", poisson, EASY_QUEUE, CAMPAIGN_FAULTS, 2, None),
            ("cons", poisson, CONS_QUEUE, CAMPAIGN_FAULTS, 1, None),
            ("easy_capped", poisson, EASY_QUEUE, CAMPAIGN_FAULTS, 2,
             SERVICE_CAP),
            ("swf_fcfs", swf, "fcfs", None, 1, None),
            ("swf_easy", swf, EASY_QUEUE, None, 2, None),
            ("swf_cons", swf, CONS_QUEUE, None, 1, None))


def _service_scheduler(queue, faults, power_cap):
    from repro_torch.core import FaultConfig, Scheduler
    from repro_torch.core.policy import make_policy
    return Scheduler(make_policy("paper", k=0.10), warm_start=True,
                     faults=None if faults is None else FaultConfig(**faults),
                     queue=queue, power_cap=power_cap, engine="events")


def service_batch_part(tmp: str) -> None:
    """The batch ``engine="events"`` runs on the card that the service
    phase's live sessions are held against, every SERVICE_FIELDS entry
    saved to ``tmp/batch.pt`` (CPU tensors, by session).  Runs in a
    process of its own (``_service_start``)."""
    import torch
    out = {}
    for name, w, queue, faults, _, cap in _service_runs():
        res = _service_scheduler(queue, faults, cap).run(w)
        out[name] = {f: getattr(res, f).cpu() for f in SERVICE_FIELDS}
    torch.save(out, os.path.join(tmp, "batch.pt"))


#: the service phases' child processes, started before ``campaign_scale``
#: (whose times compare nothing later; ``cross_device`` and
#: ``schedule_cli`` after it report none), so that the batch runs, the
#: independent sessions and the CLI runs go beside those phases and not
#: beside the live sessions and pools whose latency the service phases
#: measure: by name, (start time, output files, process,
#: its temporary directory)
SERVICE_KIDS: dict = {}
#: the children each service phase reads
KID_GROUPS = {"service": ("batch", "cli"), "service_pool": ("pool",
                                                             "pool_cli"),
              "event_campaign": ("event",), "cross_device": ("cross",)}


def _kid_command(name: str, tmp: str) -> tuple:
    """(argv, standard input) of child ``name``, writing into ``tmp``."""
    part = lambda fn: [sys.executable, "-c", "import sys, chip_smoke; "  # noqa: E731
                       f"chip_smoke.{fn}(sys.argv[1])", tmp]
    if name == "cli":
        return ([sys.executable, "-m", "repro_torch.launch.scheduler_service",
                 "--queue", "easy_backfill:window=8", "--power-cap",
                 "60000", "--checkpoint-dir", os.path.join(tmp, "ck")],
                "\n".join(json.dumps(r) for r in SERVICE_REQUESTS))
    return part({"batch": "service_batch_part", "pool": "service_pool_part",
                 "pool_cli": "service_pool_cli_part",
                 "event": "event_part", "cross": "cross_part"}[name]), ""


def _service_start(phases=tuple(KID_GROUPS)) -> None:
    """Start the children of the service phases ``phases`` that are not
    running yet, their output to files."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for name in (n for phase in phases for n in KID_GROUPS[phase]):
        if name in SERVICE_KIDS:
            continue
        tmp = tempfile.TemporaryDirectory(prefix=f"service_{name}_")
        argv, stdin = _kid_command(name, tmp.name)
        files = [open(os.path.join(tmp.name, f"{name}.{x}"), "w+")
                 for x in ("out", "err")]
        proc = subprocess.Popen(argv, cwd=ROOT, env=env, text=True,
                                stdin=subprocess.PIPE, stdout=files[0],
                                stderr=files[1])
        proc.stdin.write(stdin)
        proc.stdin.close()
        SERVICE_KIDS[name] = (time.perf_counter(), files, proc, tmp)


def _kid_dir(name: str) -> str:
    return SERVICE_KIDS[name][3].name


#: (seconds from its start, stdout) of each child joined
KID_JOINED: dict = {}


def _service_join(name: str, timeout: float = 600) -> tuple:
    """Wait for child ``name`` (once): (seconds from its start to its
    first join, its stdout)."""
    if name not in KID_JOINED:
        t0, files, proc, _ = SERVICE_KIDS[name]
        rc = proc.wait(timeout=timeout)
        seconds = time.perf_counter() - t0
        out, err = (f.seek(0) or f.read() for f in files)
        check(rc == 0, f"service {name} child exit {rc}: {err[-2000:]}")
        KID_JOINED[name] = (seconds, out)
    return KID_JOINED[name]


def _service_stop(names=None) -> None:
    """Stop the children ``names`` (default: all) still running; remove
    their files."""
    for name in list(SERVICE_KIDS if names is None else names):
        if name in SERVICE_KIDS:
            _, files, proc, tmp = SERVICE_KIDS.pop(name)
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for f in files:
                f.close()
            tmp.cleanup()


def _service_session(name, w, queue, faults, calls, counters, latencies,
                     batch, power_cap=None, ckpt=None):
    """One live session on the card against ``batch``, the batch run of the
    same scheduler (``service_batch_part``): the main path with the
    kth_free count from 0 (``calls`` launches each live step), every
    SERVICE_FIELDS entry bit-equal, each step's wall time kept in
    ``latencies``.  With ``ckpt`` (a directory) the session is also saved
    half way, restored into a fresh dispatcher and finished there: the
    same remaining decisions and result."""
    import torch
    from repro_torch.kernels.kth_free import kth_free_cuda
    from repro_torch.service import Dispatcher
    sched = _service_scheduler(queue, faults, power_cap)
    d = Dispatcher.from_scheduler(sched, w, capacity=SERVICE_C,
                                  checkpoint_dir=ckpt)
    lat = []
    observe = d.metrics.observe_step
    d.metrics.observe_step = lambda out, dt: (lat.append(dt),
                                              observe(out, dt))
    J, half = len(w.prog), len(w.prog) // 2
    torch.cuda.synchronize()
    kth_free_cuda.launches = 0
    t0 = time.perf_counter()
    _feed(d, w, range(half))
    if ckpt:
        d.save()
    _feed(d, w, range(half, J))
    d.drain()
    seconds = time.perf_counter() - t0
    n_main = kth_free_cuda.launches
    steps = d.metrics.n_steps
    _count(counters, "kth_free", f"service.{name}", n_main)
    check(n_main == calls * steps,
          f"service {name}: kth_free launches {n_main} != {calls} x "
          f"{steps} live steps")
    live = d.result()
    for f in SERVICE_FIELDS:
        a, b = batch[f], getattr(live, f).cpu()
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"service {name}: live {f} != the batch run's")
    check(len(d.decisions) == J, f"service {name}: {len(d.decisions)} "
          f"decisions for {J} jobs")
    latencies += lat
    out = dict(jobs=J, live_steps=steps, batch_steps=_event_steps(sched, w),
               seconds=seconds, ms_per_live_step=seconds / steps * 1e3,
               kth_free_launches_per_step=n_main / steps,
               steps_per_placed_job=steps / d.metrics.n_placed,
               placed=d.metrics.n_placed, n_backfilled=int(live.n_backfilled),
               decision_latency_us=_percentiles(lat),
               peak_power=float(live.peak_power),
               mean_wait=float(live.mean_wait))
    if ckpt:
        d2 = Dispatcher.from_scheduler(sched, w, capacity=SERVICE_C,
                                       checkpoint_dir=ckpt)
        check(d2.restore() and d2.n_submitted == half,
              f"service {name}: restore")
        _feed(d2, w, range(half, J))
        d2.drain()
        check(d2.decisions == d.decisions,
              f"service {name}: restored decisions differ")
        rest = d2.result()
        for f in SERVICE_FIELDS:
            check(torch.equal(getattr(rest, f), getattr(live, f)),
                  f"service {name}: restored {f} differs")
        out["checkpoint"] = dict(saved_after=half, equal=True)
    return d, out


def _event_steps(sched, w):
    from repro_torch.core import events
    f = sched.faults
    return events.step_count(w, sched.policy, bool(f and f.failure_prob > 0))


def phase_service(counters: dict) -> dict:
    """The online service on the card: live sessions (the dispatcher over
    the event cores, window 16, capacity 256) bit-equal to the batch run;
    checkpoint / restore; what-if purity and latency; one host sync a
    step; the JSONL CLI as a subprocess; decision latency.  The batch runs
    and the CLI run in the children of ``_service_start`` (started here if
    no earlier phase did); checkpoints go to a temporary directory,
    removed at the end."""
    import tempfile
    _service_start(("service",))
    try:
        with tempfile.TemporaryDirectory(prefix="service_ck_") as tmp:
            return _service_phase(counters, tmp)
    finally:
        _service_stop(KID_GROUPS["service"])


def _service_phase(counters: dict, tmp: str) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.events import _Record
    from repro_torch.service import Dispatcher, whatif
    from repro_torch.service.whatif import (CHECK_EVERY, _rollout,
                                            rollout_length)
    from repro_torch.utils.tree import flatten_with_names, map_with_names
    probe = _sync_count(lambda: torch.ones(1, device="cuda").sum().item())
    check(probe >= 1, "sync debug mode reports no sync for .item()")
    runs = _service_runs()
    poisson = runs[0][1]
    # every child ends before the first live step is timed (the pool
    # phase's too, when they run)
    batch_s, _ = _service_join("batch")
    batches = torch.load(os.path.join(_kid_dir("batch"), "batch.pt"))
    cli_s, cli_out = _service_join("cli")
    for name in KID_GROUPS["service_pool"]:
        if name in SERVICE_KIDS:
            _service_join(name)
    _event_finish()
    lat, out = [], {}
    for name, w, queue, faults, calls, cap in runs:
        d, stats = _service_session(
            name, w, queue, faults, calls, counters, lat, batches[name],
            power_cap=cap,
            ckpt=os.path.join(tmp, name) if name == "easy" else None)
        if name == "easy":
            sched = d.scheduler
        out[name] = stats
        emit("service", run=name, queue=queue, **stats)
    check(out["easy_capped"]["peak_power"] <= SERVICE_CAP * (1 + 1e-5),
          "service: the capped session's peak is over its cap")

    # one host sync per step_once (none per submit), on a fresh EASY
    # session
    ck = os.path.join(tmp, "drive")
    d = Dispatcher.from_scheduler(sched, poisson, capacity=SERVICE_C,
                                  checkpoint_dir=ck)
    syncs_submit = _sync_count(lambda: d.submit(int(poisson.prog[0]),
                                                float(poisson.arrival[0])))
    syncs_feed = _sync_count(lambda: _feed(d, poisson, range(1, 40)))
    n0 = d.metrics.n_steps
    horizon = float(poisson.arrival[40])
    syncs_steps = _sync_count(lambda: [d.step_once(horizon)
                                       for _ in range(25)])
    check(syncs_submit == 0, f"service: submit synchronised "
          f"{syncs_submit} times")
    check(syncs_feed == n0, f"service: {syncs_feed} host syncs for {n0} "
          "steps of 39 drives and submissions")
    check(syncs_steps == d.metrics.n_steps - n0 == 25,
          f"service: {syncs_steps} host syncs for 25 step_once calls")

    # what-if mid-session (40 jobs in): the live carry and job tensors
    # unchanged leaf by leaf; latency
    before = flatten_with_names(d.carry_snapshot())
    jobs = [d._ctx[k].clone() for k in ("prog", "arrival", "kjob", "K")]
    whatif_ms, proj = [], None
    for prog in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proj = whatif(d, prog)
        whatif_ms.append((time.perf_counter() - t0) * 1e3)
    after = flatten_with_names(d.carry_snapshot())
    check([n for n, _ in before] == [n for n, _ in after], "what-if leaves")
    for (name, a), (_, b) in zip(before, after):
        check(torch.equal(a, b), f"service: what-if changed carry {name}")
    for a, k in zip(jobs, ("prog", "arrival", "kjob", "K")):
        check(torch.equal(a.nan_to_num(-1.0), d._ctx[k].nan_to_num(-1.0)),
              f"service: what-if changed the session's {k}")
    check(proj["job"]["wait"] >= 0 and np.isfinite(proj["makespan"]),
          "service: what-if projection")
    # the rollout stopped at its first quiescent check against the
    # reference's full length, from the same carry: steps, ms, and the
    # same final carry and record
    roll = {}
    for every in (CHECK_EVERY, None):
        carry = map_with_names(lambda _, x: x.clone(), d._carry)
        rec = _Record(1, d.capacity, d.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, steps = _rollout(d._step, d._ctx, carry, rec,
                                rollout_length(d), every)
        torch.cuda.synchronize()
        roll[every] = (carry, rec, steps, (time.perf_counter() - t0) * 1e3)
    (c1, r1, s1, ms1), (c2, r2, s2, ms2) = roll[CHECK_EVERY], roll[None]
    check(s1 < s2 == rollout_length(d),
          f"service: rollout steps {s1} early, {s2} full")
    for (name, a), (_, b) in zip(flatten_with_names(c1),
                                 flatten_with_names(c2)):
        check(torch.equal(a, b), f"service: early-stopped rollout {name}")
    for a, b in ((r1.sel_x, r2.sel_x), (r1.vals, r2.vals), (r1.E, r2.E)):
        check(torch.equal(a[:, :-1], b[:, :-1]),
              "service: early-stopped rollout record")
    rollout = dict(every=CHECK_EVERY, steps_early=s1, ms_early=ms1,
                   steps_full=s2, ms_full=ms2)

    # the device idle share of driving the next 40 jobs: timed on the
    # session, profiled on its twin restored from the same checkpoint
    d.save()
    twin = Dispatcher.from_scheduler(sched, poisson, capacity=SERVICE_C,
                                     checkpoint_dir=ck)
    check(twin.restore(), "service: twin restore")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    before_steps = d.metrics.n_steps
    _feed(d, poisson, range(40, 80))
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    steps = d.metrics.n_steps - before_steps
    busy_us, ops = _device_busy_us(lambda: _feed(twin, poisson, range(40, 80)),
                                   count=True)
    check(twin.decisions == d.decisions, "service: twin decisions")

    # the JSONL CLI, a subprocess on the card, over the docstring's stream
    resp = [json.loads(line) for line in cli_out.splitlines() if line]
    check(len(resp) == len(SERVICE_REQUESTS) and all(r["ok"] for r in resp),
          f"service CLI responses {resp}")
    res = dict(
        decision_latency_us=_percentiles(lat),
        steps_per_placed_job={k: v["steps_per_placed_job"]
                              for k, v in out.items()},
        kth_free_launches_per_step={k: v["kth_free_launches_per_step"]
                                    for k, v in out.items()},
        whatif_ms=whatif_ms, whatif_after_jobs=40, whatif_rollout=rollout,
        host_syncs=dict(submit=syncs_submit, feed_steps=n0,
                        feed=syncs_feed, step_once_25=syncs_steps),
        drive=dict(jobs=40, steps=steps, wall_us=wall_us,
                   device_busy_us=busy_us,
                   device_ops_per_step=None if ops is None
                   else ops / steps,
                   device_idle_share=None if busy_us is None
                   else 1.0 - busy_us / wall_us),
        cli=dict(requests=len(SERVICE_REQUESTS),
                 result=resp[-1].get("totals"), child_seconds=cli_s),
        batch_child_seconds=batch_s)
    emit("service", run="summary", **res)
    return res


#: the session pool phase: pool sizes, (a)'s four sessions (K, power cap;
#: seed = the session's index), (b)'s 64 K x seed points, the job where
#: (c) saves, and the probe window (jobs) of the sync count and the
#: profiled drive
POOL_NS = (1, 4, 64)
POOL_KS = (0.05, 0.10, 0.20, 0.10)
POOL_CAPS = (None, None, None, SERVICE_CAP)
POOL_GRID_KS = 16
POOL_GRID_SEEDS = (0, 1, 2, 3)
POOL_SAVE_AT = SERVICE_C // 2
POOL_PROBE = (10, 20)
#: the ``--pool 4`` CLI child's stream: 8 jobs a session over one arrival
#: grid, each session its own program order; ``POOL_CLI_HEAD`` jobs before
#: the checkpoint and the kill
POOL_CLI_ARGV = ("--pool", "4", "--queue", "easy_backfill:window=16",
                 "--warm-start", "--capacity", "16", "--failures", "0.3")
POOL_CLI_JOBS = 8
POOL_CLI_HEAD = 4


def _pool_workload():
    """The pool's catalog and arrival grid: the campaign stream's first
    SERVICE_C jobs (the service phase's Poisson stream)."""
    return _event_stream(SERVICE_C)


def _pool_streams(w, n):
    """The program order of each of ``n`` sessions over ``w``'s arrival
    grid: four distinct orders for (a) (the stream's own, then seeded
    shuffles), the stream's own for every one of (b)'s points."""
    import numpy as np
    if n == 64:
        return [w.prog] * n
    rng = np.random.default_rng(7)
    return ([np.asarray(w.prog)]
            + [rng.permutation(w.prog) for _ in range(3)])[:n]


def _pool_scheds(n):
    """The sessions' schedulers: EASY at window 16, the campaign's faults
    (stragglers and failure re-queue), warm; (a)'s four (K, cap, seed) or
    (b)'s 64 K x seed points in the batch grid's lane order; N = 1 is
    (a)'s first."""
    import numpy as np
    from repro_torch.core import FaultConfig, Scheduler
    from repro_torch.core.policy import make_policy
    mk = lambda k, cap, seed: Scheduler(  # noqa: E731
        make_policy("paper", k=float(k)), warm_start=True,
        faults=FaultConfig(**CAMPAIGN_FAULTS), queue=EASY_QUEUE,
        power_cap=cap, seeds=seed, engine="events")
    if n == 64:
        ks = np.linspace(0.0, 0.35, POOL_GRID_KS).astype(np.float32)
        return [mk(k, None, s) for k in ks for s in POOL_GRID_SEEDS]
    return [mk(k, cap, i) for i, (k, cap)
            in enumerate(zip(POOL_KS, POOL_CAPS))][:n]


def _pool_grid_scheduler():
    """(b)'s batch run: the 64 points as one grid (K x seed)."""
    import numpy as np
    from repro_torch.core import FaultConfig, Scheduler
    from repro_torch.core.policy import make_policy
    ks = np.linspace(0.0, 0.35, POOL_GRID_KS).astype(np.float32)
    return Scheduler(make_policy("paper", k=ks), warm_start=True,
                     faults=FaultConfig(**CAMPAIGN_FAULTS), queue=EASY_QUEUE,
                     seeds=POOL_GRID_SEEDS, engine="events")


def service_pool_part(tmp: str) -> None:
    """What the pool phase is held against, on the card: (a)'s four
    sessions each as an independent ``Dispatcher`` fed its stream job by
    job, and (b)'s 64 points as one batch ``engine="events"`` run; the
    decisions and every SERVICE_FIELDS entry saved to ``tmp/pool.pt``
    (CPU tensors).  Runs in a process of its own (``_service_start``)."""
    import torch
    from repro_torch.service import Dispatcher
    w = _pool_workload()
    out = {"sessions": []}
    for sched, progs in zip(_pool_scheds(4), _pool_streams(w, 4)):
        d = Dispatcher.from_scheduler(sched, w, capacity=SERVICE_C)
        for j in range(SERVICE_C):
            d.drive(until=float(w.arrival[j]))
            d.submit(int(progs[j]), float(w.arrival[j]))
        d.drain()
        res = d.result()
        out["sessions"].append(dict(
            decisions=d.decisions,
            fields={f: getattr(res, f).cpu() for f in SERVICE_FIELDS}))
    res = _pool_grid_scheduler().run(w)
    out["grid"] = {f: getattr(res, f).cpu().reshape(
        (-1,) + tuple(getattr(res, f).shape[2:])) for f in SERVICE_FIELDS}
    out["restore"] = _pool_restore_part(w, os.path.join(tmp, "ck"))
    torch.save(out, os.path.join(tmp, "pool.pt"))


def _pool_result(pool, i) -> dict:
    """Session ``i``'s decisions and SERVICE_FIELDS (CPU tensors)."""
    res = pool.result(i)
    return dict(decisions=list(pool.sessions[i].decisions),
                fields={f: getattr(res, f).cpu() for f in SERVICE_FIELDS})


def _pool_restore_part(w, ck) -> dict:
    """(c): (a)'s 4-lane pool fed to job POOL_SAVE_AT and saved through the
    writer thread (``blocking=False``), restored into a fresh pool and
    finished; then lane 1 rolled back to the checkpoint while lanes 0, 2
    and 3 keep their state (carry leaves and record rows compared before
    and after), and finished again.  Returns the sessions' results, for
    the phase to hold against its uninterrupted pool."""
    from repro_torch.service import SessionPool
    progs = _pool_streams(w, 4)
    pool = SessionPool(_pool_scheds(4), w, capacity=SERVICE_C,
                       checkpoint_dir=ck)
    _pool_feed(pool, w, progs, 0, POOL_SAVE_AT)
    check(pool.save(blocking=False) == [0] * 4, "service_pool (c): save")
    pool.close()                          # the writer's save lands
    pool = SessionPool(_pool_scheds(4), w, capacity=SERVICE_C,
                       checkpoint_dir=ck)
    check(pool.restore() and [d.n_submitted for d in pool.sessions]
          == [POOL_SAVE_AT] * 4, "service_pool (c): restore")
    _pool_feed(pool, w, progs, POOL_SAVE_AT, SERVICE_C)
    pool.drain()
    out = {"restored": [_pool_result(pool, i) for i in range(4)]}
    keep = {i: _lane_state(pool, i) for i in (0, 2, 3)}
    check(pool.restore(session=1)
          and pool.sessions[1].n_submitted == POOL_SAVE_AT,
          "service_pool (c): restore of session 1")
    moved = [i for i, before in keep.items()
             if not _same_tensors(before, _lane_state(pool, i))]
    _pool_feed(pool, w, progs, POOL_SAVE_AT, SERVICE_C, session=1)
    pool.drain(session=1)
    moved += [i for i, before in keep.items()
              if not _same_tensors(before, _lane_state(pool, i))]
    out.update(rolled_back=_pool_result(pool, 1), lanes_moved=moved)
    pool.close()
    return out


def _pool_cli_requests():
    """(head, tail, finish) of the ``--pool 4`` CLI run: session i's job j
    is program ``(i + j) % 5`` at 20 j seconds."""
    sub = lambda i, j: {"op": "submit", "session": i,  # noqa: E731
                        "prog": (i + j) % 5, "arrival": 20.0 * j}
    head = [sub(i, j) for j in range(POOL_CLI_HEAD) for i in range(4)]
    tail = [sub(i, j) for j in range(POOL_CLI_HEAD, POOL_CLI_JOBS)
            for i in range(4)]
    finish = ([{"op": "drain"}]
              + [{"op": "result", "session": i} for i in range(4)]
              + [{"op": "metrics"}])
    return head, tail, finish


def service_pool_cli_part(tmp: str) -> None:
    """The ``--pool 4 --decision-log`` CLI on the card, three processes:
    one fed the head of the stream, a drive and a checkpoint, then killed
    (SIGKILL) once the checkpoint has answered, and beside it one fed the
    whole stream uninterrupted; then one started with ``--restore`` and
    fed the rest.  Responses, decision logs and each process's seconds
    saved to ``tmp/pool_cli.json``."""
    head, tail, finish = _pool_cli_requests()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    base = [sys.executable, "-m", "repro_torch.launch.scheduler_service",
            *POOL_CLI_ARGV]
    ck = ["--checkpoint-dir", os.path.join(tmp, "ck")]
    log = lambda n: ["--decision-log", os.path.join(tmp, f"{n}.jsonl")]  # noqa: E731
    text = lambda reqs: "".join(json.dumps(r) + "\n" for r in reqs)  # noqa: E731
    start = lambda argv: (time.perf_counter(), subprocess.Popen(  # noqa: E731
        argv, cwd=ROOT, env=env, text=True, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    out, seconds = {}, {}
    # the first (answer the head, a drive and the checkpoint, then die)
    # and the uninterrupted one, side by side
    first = head + [{"op": "drive", "until": 20.0 * POOL_CLI_HEAD},
                    {"op": "checkpoint"}]
    t1, p1 = start(base + ck + log("first"))
    t2, p2 = start(base + log("solo"))
    p1.stdin.write(text(first))
    p1.stdin.flush()
    out["first"] = [json.loads(p1.stdout.readline()) for _ in first]
    p1.kill()
    out["first_rc"] = p1.wait()
    seconds["first"] = time.perf_counter() - t1
    runs = {"solo": (t2, p2, head + tail + finish)}
    t3, p3 = start(base + ck + ["--restore"] + log("second"))
    runs["second"] = (t3, p3, tail + finish)
    for name, (t0, proc, reqs) in runs.items():
        stdout, stderr = proc.communicate(text(reqs), timeout=600)
        seconds[name] = time.perf_counter() - t0
        check(proc.returncode == 0, f"pool CLI {name}: {stderr[-2000:]}")
        out[name] = [json.loads(x) for x in stdout.splitlines() if x]
    out["logs"] = {}
    for name in ("first", "second", "solo"):
        with open(os.path.join(tmp, f"{name}.jsonl")) as f:
            out["logs"][name] = [json.loads(x) for x in f if x.strip()]
    out["seconds"] = seconds
    with open(os.path.join(tmp, "pool_cli.json"), "w") as f:
        json.dump(out, f)


def _pool_feed(pool, w, progs, lo, hi, session=None):
    """Drive the pool (all lanes, or ``session``) to each arrival of jobs
    ``lo`` .. ``hi - 1`` and submit them."""
    for j in range(lo, hi):
        t = float(w.arrival[j])
        pool.drive(t, session=session)
        for i in range(pool.n) if session is None else (session,):
            pool.submit(i, int(progs[i][j]), t)


def _lane_state(pool, i):
    """Lane ``i``'s carry leaves and per-job record (the sentinel column,
    which every step placing nothing writes, left out), as copies."""
    from repro_torch.utils.tree import flatten_with_names
    rec = pool._rec
    return ([x[i].clone() for _, x in flatten_with_names(pool._carry)]
            + [x[i, :-1].clone() for x in (rec.E, rec.sel_x, rec.vals)])


def _same_tensors(a, b) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and bool((x.nan_to_num(-1.0)
                                     == y.nan_to_num(-1.0)).all())
        for x, y in zip(a, b))


#: the sums over jobs, which the card reduces in an order that follows
#: the lane count of the result ([1, J] for a session, [64, J] for (b)'s
#: batch run)
POOL_SUMS = ("total_energy", "total_wait", "slowdown_sum")


def _one_lane_sums(fields) -> dict:
    """The sums over jobs of one lane's per-job ``fields`` (CPU tensors
    [J]) reduced on the card as a one-lane result reduces them
    (``events._event_results``: runtime and energy laid out in pairs)."""
    import torch
    T, E = torch.stack([fields["runtime"], fields["energy"]], -1)[None] \
        .cuda().unbind(-1)
    wait = fields["wait"][None].cuda().contiguous()
    return {"total_energy": E.sum(-1)[0], "total_wait": wait.sum(-1)[0],
            "slowdown_sum": ((wait + T) / T).sum(-1)[0]}


def _pool_check(pool, i, want, what, lanes_apart=False):
    """Session ``i`` of ``pool`` against ``want`` (decisions, when given,
    and fields): every SERVICE_FIELDS entry bit-equal; with
    ``lanes_apart`` (``want`` a lane of a wider batch run) the sums over
    jobs bit-equal to ``want``'s per-job values reduced at one lane and
    within rtol 1e-6 of ``want``'s own sums.  Returns the largest
    relative difference of those sums."""
    import torch
    res = pool.result(i)
    if want.get("decisions") is not None:
        check(pool.sessions[i].decisions == want["decisions"],
              f"service_pool {what}: session {i} decisions differ")
    one = _one_lane_sums(want["fields"]) if lanes_apart else {}
    worst = 0.0
    for f in SERVICE_FIELDS:
        a, b = want["fields"][f], getattr(res, f).cpu()
        check(a.dtype == b.dtype, f"service_pool {what}: {f} dtype")
        if f in one:
            check(torch.equal(one[f].cpu(), b), f"service_pool {what}: "
                  f"session {i} {f} != its jobs' values summed at one lane")
            rel = float(((a - b).abs() / a.abs().clamp_min(1e-30)).max())
            check(rel <= 1e-6, f"service_pool {what}: session {i} {f} "
                  f"rel {rel}")
            worst = max(worst, rel)
        else:
            check(torch.equal(a, b),
                  f"service_pool {what}: session {i} {f} differs")
    return worst


def _pool_timed(n, w, counters):
    """The pool of ``n`` sessions fed the whole stream through all-lane
    drives and drained, timed: the main path with the kth_free count from
    0 (exactly 2 launches a pool step), the wall of every pool step."""
    import torch
    from repro_torch.kernels.kth_free import kth_free_cuda
    from repro_torch.service import SessionPool
    progs = _pool_streams(w, n)
    t_build = time.perf_counter()
    pool = SessionPool(_pool_scheds(n), w, capacity=SERVICE_C)
    t_build = time.perf_counter() - t_build
    lat = []
    m0 = pool.sessions[0].metrics
    observe = m0.observe_step
    m0.observe_step = lambda out, dt: (lat.append(dt * n), observe(out, dt))
    torch.cuda.synchronize()
    kth_free_cuda.launches = 0
    t0 = time.perf_counter()
    _pool_feed(pool, w, progs, 0, SERVICE_C)
    pool.drain()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, steps = kth_free_cuda.launches, pool.n_pool_steps
    _count(counters, "kth_free", f"service_pool.N{n}", launches)
    check(launches == 2 * steps, f"service_pool N={n}: kth_free launches "
          f"{launches} != 2 x {steps} pool steps")
    check(len(lat) == steps, "service_pool: a step's wall time went missing")
    for d in pool.sessions:
        check(len(d.decisions) == SERVICE_C, f"service_pool N={n}: "
              f"{len(d.decisions)} decisions for {SERVICE_C} jobs")
    us = _percentiles(lat)
    return pool, dict(
        sessions=n, jobs_per_session=SERVICE_C, pool_steps=steps,
        seconds=seconds, build_seconds=t_build, wall_us_per_step=us,
        share_us_per_session_step=us["mean"] / n,
        kth_free_launches_per_step=launches / steps,
        decisions_per_second=n * SERVICE_C / seconds)


def _pool_probe(n, w):
    """On a fresh pool of ``n``: the host syncs of submitting one job to
    every session (none) and of the drives and submissions of the jobs
    before POOL_PROBE[0] (one a pool step); the wall of the drives of the
    next POOL_PROBE jobs, then the next as many profiled: device
    operations a pool step and the device's idle share (device µs a
    profiled step over wall µs a timed one)."""
    import torch
    from repro_torch.service import SessionPool
    progs = _pool_streams(w, n)
    lo, hi = POOL_PROBE
    pool = SessionPool(_pool_scheds(n), w, capacity=SERVICE_C)
    t = float(w.arrival[0])
    # what earlier phases left is released first, so no release is counted
    gc.collect()
    sites_submit = _sync_sites(lambda: [pool.submit(i, int(progs[i][0]), t)
                                        for i in range(n)])
    sites_feed = _sync_sites(lambda: _pool_feed(pool, w, progs, 1, lo))
    syncs_submit, syncs_feed = len(sites_submit), len(sites_feed)
    steps_feed = pool.n_pool_steps
    check(syncs_submit == 0, f"service_pool N={n}: {n} submits made "
          f"{syncs_submit} host syncs at {sites_submit}")
    check(syncs_feed == steps_feed, f"service_pool N={n}: {syncs_feed} "
          f"host syncs for {steps_feed} pool steps, at "
          f"{sorted(set(sites_feed))}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _pool_feed(pool, w, progs, lo, hi)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    steps = pool.n_pool_steps - steps_feed
    s0 = pool.n_pool_steps
    busy_us, ops = _device_busy_us(lambda: _pool_feed(
        pool, w, progs, hi, 2 * hi - lo), count=True)
    prof_steps = pool.n_pool_steps - s0
    pool.close()
    return dict(
        host_syncs=dict(submit_all_sessions=syncs_submit,
                        feed_pool_steps=steps_feed, feed=syncs_feed),
        drive=dict(jobs=hi - lo, pool_steps=steps, wall_us=wall_us,
                   profiled_steps=prof_steps, device_busy_us=busy_us,
                   device_ops_per_step=None if ops is None
                   else ops / prof_steps,
                   device_idle_share=None if busy_us is None
                   else 1.0 - busy_us / prof_steps / (wall_us / steps)))


def phase_service_pool(counters: dict) -> dict:
    """The online service's session pool on the card (EASY, window 16,
    capacity 256, the campaign stream's faults with failure re-queue):
    (a) 4 sessions on 4 streams (program orders over one arrival grid),
    differing in K, cap (one at 45 kW) and seed, each bit-equal on its
    decisions and every SERVICE_FIELDS entry to an independent
    ``Dispatcher``; (b) 64 K x seed sessions lane for lane equal to one
    batch ``engine="events"`` run (bit-equal, but the sums over jobs,
    which the card reduces in an order that follows the lane count:
    within rtol 1e-6, and bit-equal to the batch lane's per-job values
    reduced at one lane); at N = 1, 4 and 64 the wall per pool step, the
    per-session share, kth_free launches a pool step (exactly 2), host
    syncs (one a pool step, none a submit), device operations a pool
    step and a drive's idle share; (c) the 4-lane pool saved mid-stream
    through the writer, restored into a fresh pool and finished equal to
    (a)'s, then one lane rolled back while the others keep their state,
    and finished equal again; (d) the ``--pool 4 --decision-log`` CLI
    killed after a checkpoint, ``--restore``d, equal to an uninterrupted
    run.  The independent sessions, the batch run, (c)'s pools and the
    CLI run in the children of ``_service_start``."""
    _service_start(("service_pool",))
    try:
        return _service_pool_phase(counters)
    finally:
        _service_stop(KID_GROUPS["service_pool"])


def _service_pool_phase(counters: dict) -> dict:
    import torch
    from repro_torch.service import SessionPool
    w = _pool_workload()
    parts, t_part = {}, [time.perf_counter()]

    def lap(name):                        # seconds of each part
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    ref_s, _ = _service_join("pool")
    ref = torch.load(os.path.join(_kid_dir("pool"), "pool.pt"))
    out = {}
    lap("join")
    # (a) and N = 4; N = 1 on (a)'s first
    pool4, out[4] = _pool_timed(4, w, counters)
    lap("N=4")
    for i in range(4):
        _pool_check(pool4, i, ref["sessions"][i], "(a)")
    pool1, out[1] = _pool_timed(1, w, counters)
    _pool_check(pool1, 0, ref["sessions"][0], "N=1")
    pool1.close()
    lap("N=1")
    # (b) and N = 64
    pool64, out[64] = _pool_timed(64, w, counters)
    lap("N=64")
    out[64]["sums_rel_to_batch_max"] = max(
        _pool_check(pool64, i, {"fields": {
            f: x[i] for f, x in ref["grid"].items()}}, "(b)",
            lanes_apart=True) for i in range(64))
    pool64.close()
    lap("(b) checks")
    for n in POOL_NS:
        out[n].update(_pool_probe(n, w))
        lap(f"probe N={n}")
        emit("service_pool", run=f"N={n}", **out[n])

    # (c), run in the child: the restored pool and the rolled-back lane
    # against the uninterrupted pool (a)
    rest = ref["restore"]
    for i in range(4):
        _pool_check(pool4, i, rest["restored"][i], "(c) restored")
    _pool_check(pool4, 1, rest["rolled_back"], "(c) rolled back")
    check(not rest["lanes_moved"], "service_pool (c): rolling session 1 "
          f"back moved lanes {rest['lanes_moved']}")
    pool4.close()
    lap("(c)")

    # (d) the CLI child: killed after its checkpoint, restored, finished
    cli_s, _ = _service_join("pool_cli")
    with open(os.path.join(_kid_dir("pool_cli"), "pool_cli.json")) as f:
        cli = json.load(f)
    head, tail, finish = _pool_cli_requests()
    first, second, solo = cli["first"], cli["second"], cli["solo"]
    check(all(r["ok"] for r in first + second + solo),
          "service_pool CLI: a request failed")
    check(first[-1]["steps"] == [0, 0, 0, 0] and cli["first_rc"] != 0,
          "service_pool CLI: checkpoint, then killed")
    banner = second[0]
    check(banner["resumed"] and banner["sessions"] == 4
          and banner["n_submitted"] == [POOL_CLI_HEAD] * 4,
          f"service_pool CLI banner {banner}")
    check(solo[-5:-1] == second[-5:-1],
          "service_pool CLI: restored results differ from uninterrupted")
    key = lambda r: (r["session"], r["job"])  # noqa: E731
    logs = cli["logs"]
    decided = [{"session": int(i), **d} for r in solo
               for i, ds in (r.get("decisions") or {}).items() for d in ds]
    check(sorted(logs["solo"], key=key) == sorted(decided, key=key)
          and len(decided) == 4 * POOL_CLI_JOBS,
          "service_pool CLI: the decision log misses decisions")
    check(all(r in logs["solo"] for r in logs["first"] + logs["second"]),
          "service_pool CLI: a logged decision of the killed or restored "
          "run is not the uninterrupted run's")
    res = dict(
        by_n={str(n): out[n] for n in POOL_NS},
        kth_free_launches_per_step={str(n): out[n][
            "kth_free_launches_per_step"] for n in POOL_NS},
        restore=dict(saved_after=POOL_SAVE_AT, equal=True,
                     lane_rolled_back=1, others_unchanged=True),
        cli=dict(sessions=4, jobs_per_session=POOL_CLI_JOBS,
                 killed_after=POOL_CLI_HEAD, equal=True,
                 logged={k: len(v) for k, v in logs.items()},
                 child_seconds=cli_s, process_seconds=cli["seconds"]),
        reference_child_seconds=ref_s, part_seconds=parts)
    lap("(d)")
    emit("service_pool", run="summary", **res)
    return res


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
#: decode steps of the serving cells' idle-share probe (31 until PR 23;
#: ``serve.main`` times its own 31)
SERVE_IDLE_STEPS = 8


def _serve_setup():
    """The serving phases' numerics (no TF32, no reduced-precision bf16
    reductions), a fresh peak-memory count, and ``(wrappers, counted)``:
    ``counted(fn)`` sets every kernel count to 0 just before ``fn()``,
    synchronises, and returns (its result, its seconds, the counts just
    after)."""
    import torch
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
    return wrappers, counted


def _decode_loop_stats(api, params, logits, steps, sync_steps=(4, 8)):
    """Device idle share of ``steps`` greedy decode steps (1 - device busy
    time from the profiler / wall of the same loop unprofiled), device
    operations per step, and the host synchronisations of the loop at the
    two lengths ``sync_steps`` (which must not grow with the steps)."""
    import torch
    from repro_torch.launch.serve import greedy_decode
    cache = api.init_decode_cache(logits.shape[0],
                                  max(steps, *sync_steps) + 1)

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
    syncs = {n: _sync_count(lambda: run(n)) for n in sync_steps}
    check(len(set(syncs.values())) == 1,
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


def _half_chunk(api):
    """The same model at half its SSD chunk (the floor of SSD prefills)."""
    import dataclasses
    from repro_torch.models import build_model
    cfg = api.cfg
    return build_model(cfg.with_overrides(ssm=dataclasses.replace(
        cfg.ssm, chunk=cfg.ssm.chunk // 2)))


def _chunk_floor(api, params, batch, plain):
    """max |plain prefill logits - the plain prefill at half the SSD
    chunk|: the same sums rounded in another order, the floor the kernel's
    difference is read against."""
    return float((_half_chunk(api).prefill(params, batch, force="torch")
                  - plain).abs().max())


def phase_serve(counters: dict, phase: str) -> None:
    """One serving cell at full width on the card: the main path of its
    slice.  Every kernel count is set to 0 just before each run and read
    just after; the 4 x 4,096 prefill's counts go to ``counters``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    arch, kernel, band = SERVE_CELLS[phase]
    wrappers, counted = _serve_setup()

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
    _count(counters, kernel, phase, launches[kernel])
    KEPT[f"{phase}_prefill_s"] = t_prefill
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

    res, t_main, decode_launches = counted(
        lambda: serve.main(["--arch", arch]))
    check(not any(decode_launches.values()),
          f"decode launched {decode_launches}")
    check(res["steps"] == 31 and bool(torch.isfinite(res["logits"]).all()),
          "serve.main decodes 31 timed steps with finite logits")
    idle = _decode_loop_stats(api, params, logits, SERVE_IDLE_STEPS)
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
         prefill_kernel=kernel, prefill_launches=launches[kernel],
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


#: the rest of the serving stack: phase -> [(arch, layers (depth cut, or
#: None for the published depth), its parameters by the reference's
#: ``param_specs``)]
FAMILY_CELLS = {
    "serve_moe": [("moonshot-v1-16b-a3b", None, 28_057_995_264),
                  ("llama4-scout-17b-a16e", 4, 10_374_067_200)],
    "serve_hybrid": [("jamba-v0.1-52b", 8, 13_267_656_416)],
    "serve_encdec": [("whisper-medium", None, 793_338_880)],
    "serve_vlm": [("phi-3-vision-4.2b", None, 3_821_079_552)],
}
#: |logits(kernel prefill) - logits(force="torch" prefill)| bands by arch
#: and dtype, set from the floor each phase measures and prints: the
#: plain prefill against itself at flash block 256 (Jamba: at half the
#: SSD chunk), the same sums rounded in another order -- and, for MoE,
#: routed otherwise where two experts' probabilities differ in the last
#: bits.  bf16: three times the floor an H100 showed, rounded up
#: (moonshot 0.0953 with 36,974 routing flips, llama4-scout 0.0594,
#: Jamba 0.0984, Whisper 0.0408, phi-3-vision 0.0680; the kernel runs
#: differed by 1.20 / 1.61 / 0.72 / 0.98 / 1.00 x those); f32: 1e-3, as
#: for the dense and SSM cells (1.8e-5 to 5.7e-5 seen).  PERF.md "Parity
#: bands"
FAMILY_BANDS = {
    "moonshot-v1-16b-a3b": {"bfloat16": 0.3, "float32": 1e-3},
    "llama4-scout-17b-a16e": {"bfloat16": 0.18, "float32": 1e-3},
    "jamba-v0.1-52b": {"bfloat16": 0.3, "float32": 1e-3},
    "whisper-medium": {"bfloat16": 0.13, "float32": 1e-3},
    "phi-3-vision-4.2b": {"bfloat16": 0.21, "float32": 1e-3},
}
#: prompt of the decoder-only prefills: batch x tokens
FAMILY_PROMPT = {"moonshot-v1-16b-a3b": (2, 4096),
                 "llama4-scout-17b-a16e": (2, 4096),
                 "jamba-v0.1-52b": (2, 4096),
                 "whisper-medium": (4, 2048),
                 "phi-3-vision-4.2b": (4, 4096 - 576)}
#: decode-loop steps of the idle-share probe (``_decode_loop_stats``; its
#: host syncs at 2 and 4 steps), by arch: reading back a trace costs about
#: 0.3 ms an event, and a moonshot step has 7,167 device operations
FAMILY_IDLE_STEPS = {"moonshot-v1-16b-a3b": 2}


def _idle_probe(api, params, logits) -> dict:
    """``_decode_loop_stats`` for the new serving cells, and its seconds."""
    t0 = time.perf_counter()
    row = _decode_loop_stats(api, params, logits,
                             FAMILY_IDLE_STEPS.get(api.cfg.name, 4),
                             sync_steps=(2, 4))
    row["idle_probe_s"] = time.perf_counter() - t0
    return row
#: phi-3-vision's f32 prompt: 576 patches + 1,472 tokens (2,048
#: positions, still the flash branch), cut from 4,096 for the time
VLM_F32_TOKENS = 2048 - 576


def _family_config(arch, layers, **kw):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.with_overrides(n_layers=layers)
    return cfg.with_overrides(**kw) if kw else cfg


def _free() -> None:
    """Give the caching allocator's free blocks back after a ``del``."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _moe_routes():
    """A context that records every MoE layer's top-k ids and kept mask
    (sorted order) of the runs inside it, by patching
    ``repro_torch.models.moe.route`` / ``dispatch``; yields the record."""
    import contextlib
    from repro_torch.models import moe

    @contextlib.contextmanager
    def ctx():
        rec = {"ids": [], "keep": []}
        real_route, real_dispatch = moe.route, moe.dispatch

        def route(*a, **kw):
            out = real_route(*a, **kw)
            rec["ids"].append(out[1])
            return out

        def dispatch(*a, **kw):
            out = real_dispatch(*a, **kw)
            rec["keep"].append(out[1])
            return out
        moe.route, moe.dispatch = route, dispatch
        try:
            yield rec
        finally:
            moe.route, moe.dispatch = real_route, real_dispatch
    return ctx()


def _routing(a, b) -> dict:
    """Routing flips between two runs' records: (layer, token) whose top-k
    expert sets differ, per MoE layer; and the (token, slot) entries
    dropped at capacity per MoE layer in run ``a``."""
    flips = [int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
             for x, y in zip(a["ids"], b["ids"])]
    return dict(routing_flips=sum(flips), routing_flips_by_layer=flips,
                dropped_by_layer=[int((~k).sum()) for k in a["keep"]],
                moe_layers=len(a["ids"]))


def _flash_block(block):
    """A context in which the flash dispatch's plain version runs at tiles
    of ``block`` (the floor of the flash prefills)."""
    import contextlib
    from repro_torch.models import attention

    @contextlib.contextmanager
    def ctx():
        real = attention.ops.flash_attention
        attention.ops.flash_attention = lambda *a, **kw: real(
            *a, **{**kw, "block_q": block, "block_k": block})
        try:
            yield
        finally:
            attention.ops.flash_attention = real
    return ctx()


def _family_prefill(api, params, batch, counted, wrappers, expect, routes,
                    floor=None):
    """The kernel prefill (launching exactly ``expect``, a kernel -> count
    map, and nothing else), its ``force="torch"`` run (nothing launched)
    and, if ``floor`` ('flash' or 'ssd'), the plain run at flash block 256
    or half the SSD chunk: logits held to the arch's band, argmax equal
    where the plain run's top-2 margin exceeds it, MoE routing flips and
    drops.  Returns (kernel logits, the row)."""
    import torch
    cfg = api.cfg
    band = FAMILY_BANDS[cfg.name][cfg.dtype]
    with _moe_routes() as r_kernel:
        logits, t_kernel, launches = counted(lambda: api.prefill(params,
                                                                 batch))
    check(launches == {**dict.fromkeys(wrappers, 0), **expect},
          f"{cfg.name} {cfg.dtype} prefill launched {launches}, expected "
          f"{expect}")
    routes_taken = {n: wrappers[n].last_route for n in expect}
    check(all(r == routes[n] for n, r in routes_taken.items()),
          f"{cfg.name} {cfg.dtype} prefill routes {routes_taken}, expected "
          f"{routes}")
    with _moe_routes() as r_plain:
        plain, t_plain, plain_launches = counted(
            lambda: api.prefill(params, batch, force="torch"))
    check(not any(plain_launches.values()),
          f"force='torch' launched {plain_launches}")
    b = batch["tokens"].shape[0]
    check(logits.shape == (b, cfg.vocab_size) and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), f"{cfg.name} logits")
    diff = float((logits - plain).abs().max())
    row = dict(prefill_s=t_kernel, prefill_plain_s=t_plain,
               prefill_launches=expect, routes=routes_taken,
               logits_max_abs_diff=diff, logit_band=band,
               logits_abs_max=float(plain.abs().max()))
    if floor is not None:
        t0 = time.perf_counter()
        with _moe_routes() as r_floor:
            if floor == "flash":
                with _flash_block(256):
                    again = api.prefill(params, batch, force="torch")
            else:
                again = _half_chunk(api).prefill(params, batch,
                                                 force="torch")
        row["floor"] = ("plain at flash block 256" if floor == "flash"
                        else "plain at half the SSD chunk")
        row["floor_logits_max_abs_diff"] = float((again - plain).abs().max())
        row["floor_s"] = time.perf_counter() - t0
        if r_floor["ids"]:
            row["floor_routing_flips"] = _routing(r_floor, r_plain)[
                "routing_flips"]
        del again
    check(diff <= band, f"{cfg.name} {cfg.dtype} kernel vs plain prefill "
          f"logits differ by {diff} (band {band}; {row})")
    top2 = plain.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    clear = margin > band
    same = logits.argmax(-1) == plain.argmax(-1)
    check(bool(same[clear].all()), f"{cfg.name}: argmax differs where the "
          f"top-2 margin exceeds the band: {margin.tolist()}")
    row.update(top2_margin=margin.tolist(), argmax_equal=same.tolist())
    if r_kernel["ids"]:
        row.update(_routing(r_kernel, r_plain))
    return logits, row


def _timed(fn) -> float:
    """Seconds of ``fn()``, synchronised."""
    import torch
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _family_params(api, expected):
    """Seeded weights on the card, their count held to the reference's."""
    import torch
    t0 = time.perf_counter()
    params = api.init_params(0)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    check(n == expected, f"{api.cfg.name} at {api.cfg.n_layers} layers: "
          f"{n} parameters, the reference's param_specs count {expected}")
    return params, dict(params=n, init_s=time.perf_counter() - t0)


def _tokens(cfg, shape, seed=1):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                         device="cuda")


def _serve_main(counted, arch) -> dict:
    """``launch.serve.main`` at its defaults on the card: no kernel, 31
    timed steps, finite logits."""
    import torch
    from repro_torch.launch import serve
    res, t_main, launches = counted(lambda: serve.main(["--arch", arch]))
    check(not any(launches.values()), f"{arch} decode launched {launches}")
    check(res["steps"] == 31 and bool(torch.isfinite(res["logits"]).all()),
          f"{arch}: serve.main decodes 31 timed steps with finite logits")
    return dict(decode_batch=4, decode_steps=res["steps"],
                decode_ms_per_step=res["ms_per_step"],
                decode_tokens_per_s=res["tokens_per_s"], serve_main_s=t_main)


def _teacher_forced(api, params, cache, tokens):
    """Decode ``tokens`` [b, n] one position at a time: the last logits."""
    for pos in range(tokens.shape[1]):
        logits, cache = api.decode_step(params, cache,
                                        tokens[:, pos:pos + 1], pos)
    return logits


def _fill_memory(api, params, cache, frames):
    """Whisper's cross-attention memory from ``encode``'s output through
    each decoder layer's ``xattn`` K/V projection."""
    from repro_torch.models import attention, encdec
    enc = encdec.encode(api.cfg, params, frames)
    for i, lp in enumerate(params["dec_layers"]):
        _, (k, v) = attention.attn_forward(
            lp["xattn"], enc, api.cfg, causal=False, use_rope=False,
            kv_x=enc, return_kv=True)
        cache["mem_k"][i].copy_(k)
        cache["mem_v"][i].copy_(v)
    return cache


def phase_serve_moe(counters: dict) -> dict:
    """moonshot-v1-16b-a3b at full width and depth and llama4-scout at
    full width, depth cut to 4 (the full model needs sharding)."""
    import torch
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.models import build_model
    wrappers, counted = _serve_setup()
    tc = {"flash_attention": "tensor-core"}
    out = {}
    for arch, layers, n_params in FAMILY_CELLS["serve_moe"]:
        cfg = _family_config(arch, layers)
        api = build_model(cfg)
        params, row = _family_params(api, n_params)
        tokens = _tokens(cfg, FAMILY_PROMPT[arch])
        batch = {"tokens": tokens}
        row["warmup_s"] = _timed(lambda: api.prefill(params, batch))
        n_attn = cfg.n_layers
        logits, pre = _family_prefill(api, params, batch, counted, wrappers,
                                      {"flash_attention": n_attn}, tc,
                                      floor="flash")
        _count(counters, "flash_attention", f"serve_moe.{arch}", n_attn)
        row.update(pre, layers=cfg.n_layers, d_model=cfg.d_model,
                   experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                   capacity=_moe_capacity(cfg, tokens.numel()),
                   prompt=list(tokens.shape),
                   prefill_tokens_per_s=tokens.numel() / pre["prefill_s"])
        if arch == MOE_SHARDED[0]:
            row["sharded_dispatch"] = _moe_sharded(api, params, counted,
                                                   wrappers, tc, counters)
        if layers is not None:
            # the depth-cut config's decode (serve.main builds the full
            # one): 31 greedy steps
            cache = api.init_decode_cache(logits.shape[0], 32)
            dec, t_dec, launches = counted(lambda: greedy_decode(
                api, params, cache, logits, 0, 31))
            check(not any(launches.values())
                  and bool(torch.isfinite(dec).all()),
                  f"{arch} greedy decode launched {launches} or is not "
                  f"finite")
            row.update(decode_batch=logits.shape[0], decode_steps=31,
                       decode_ms_per_step=t_dec / 31 * 1e3)
            del cache
        row.update(_idle_probe(api, params, logits))
        del params
        _free()
        if layers is None:
            # f32 at 4 layers (48 do not fit), then serve.main, which draws
            # its own full-size weights
            api32 = build_model(cfg.with_overrides(n_layers=4,
                                                   dtype="float32"))
            params32 = api32.init_params(0)
            _, pre32 = _family_prefill(
                api32, params32, batch, counted, wrappers,
                {"flash_attention": 4}, {"flash_attention": "f32-core"})
            _count(counters, "flash_attention", f"serve_moe.{arch}.f32", 4)
            row["f32_4_layers"] = pre32
            del params32
            _free()
            row.update(_serve_main(counted, arch))
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out[arch] = row
    emit("serve_moe", cells=out, nvidia_smi=nvidia_smi())
    return out


#: per-shard MoE dispatch: the arch and its prefill [b, s] under the
#: single-pod production rules (dp_shards 16 divides b; s = 2,048, the
#: least that takes the flash branch)
MOE_SHARDED = ("moonshot-v1-16b-a3b", (16, 2048))


def _moe_sharded(api, params, counted, wrappers, routes, counters) -> dict:
    """The prefill under ``use_rules(make_production_mesh(),
    lm_rules(False))``: every MoE layer buckets its tokens in 16 data
    shards (each shard's sort, capacity and drops its own), the kernel
    route against ``force="torch"`` in the phase's band beside its floor,
    and the drops per layer against the same prefill in one shard."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.moe import moe_capacity
    from repro_torch.sharding import lm_rules, use_rules
    cfg = api.cfg
    tokens = _tokens(cfg, MOE_SHARDED[1], seed=2)
    batch = {"tokens": tokens}
    with _moe_routes() as one:
        counted(lambda: api.prefill(params, batch))
    rules = lm_rules(False)
    n = rules["dp_shards"]
    with use_rules(make_production_mesh(device=api.device), rules), \
            _moe_routes() as rec:
        _, row = _family_prefill(api, params, batch, counted, wrappers,
                                 {"flash_attention": cfg.n_layers}, routes,
                                 floor="flash")
    _count(counters, "flash_attention", "serve_moe.sharded", cfg.n_layers)
    keep = rec["keep"][:len(one["keep"])]           # the kernel run's
    t_loc = tokens.numel() // n
    check(all(k.shape == (n, t_loc * cfg.moe.top_k) for k in keep),
          f"sharded dispatch kept masks {[tuple(k.shape) for k in keep]}")
    one_drops = [int((~k).sum()) for k in one["keep"]]
    row.update(dp_shards=n, prompt=list(tokens.shape),
               capacity_per_shard=moe_capacity(t_loc, cfg),
               capacity_one_shard=moe_capacity(tokens.numel(), cfg),
               dropped_one_shard_by_layer=one_drops,
               dropped_total=sum(row["dropped_by_layer"]),
               dropped_one_shard_total=sum(one_drops),
               layers_with_other_drops=sum(
                   a != b for a, b in zip(row["dropped_by_layer"],
                                          one_drops)))
    return row


def _moe_capacity(cfg, tokens):
    from repro_torch.models.moe import moe_capacity
    return moe_capacity(tokens, cfg)


JAMBA_F32_PROMPT = (2, 4096)


def phase_serve_hybrid(counters: dict) -> dict:
    """jamba-v0.1-52b at full width, one 8-layer group (attention at
    layer 3, Mamba-2 at the other seven, MoE at the odd layers)."""
    import dataclasses
    import torch
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.models import build_model
    wrappers, counted = _serve_setup()
    (arch, layers, n_params), = FAMILY_CELLS["serve_hybrid"]
    cfg = _family_config(arch, layers)
    api = build_model(cfg)
    params, row = _family_params(api, n_params)
    tokens = _tokens(cfg, FAMILY_PROMPT[arch])
    batch = {"tokens": tokens}
    row["warmup_s"] = _timed(lambda: api.prefill(params, batch))
    expect = {"ssd_scan": 7, "flash_attention": 1}
    logits, pre = _family_prefill(
        api, params, batch, counted, wrappers, expect,
        {"ssd_scan": "tensor-core", "flash_attention": "tensor-core"},
        floor="ssd")
    for kernel, n in expect.items():
        _count(counters, kernel, "serve_hybrid", n)
    row.update(pre, layers=cfg.n_layers, d_model=cfg.d_model,
               prompt=list(tokens.shape),
               capacity=_moe_capacity(cfg, tokens.numel()),
               prefill_tokens_per_s=tokens.numel() / pre["prefill_s"])
    # 31 greedy steps over the mixed cache: 1 K/V layer, 7 conv/state
    cache = api.init_decode_cache(2, 32)
    check(set(cache) == {"k", "v", "conv", "state"}
          and cache["k"].shape[0] == 1 and cache["conv"].shape[0] == 7
          and cache["state"].shape[0] == 7,
          f"Jamba's decode cache {({k: tuple(v.shape) for k, v in cache.items()})}")
    row["decode_cache"] = {k: list(v.shape) for k, v in cache.items()}
    dec, t_dec, launches = counted(lambda: greedy_decode(
        api, params, cache, logits, 0, 31))
    check(not any(launches.values()) and bool(torch.isfinite(dec).all()),
          f"Jamba greedy decode launched {launches} or is not finite")
    row.update(decode_batch=2, decode_steps=31,
               decode_ms_per_step=t_dec / 31 * 1e3,
               **_idle_probe(api, params, logits))
    row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del params, cache
    _free()

    # f32 at the same group (53 GB), then the teacher-forced decode
    torch.cuda.reset_peak_memory_stats()
    cfg32 = cfg.with_overrides(dtype="float32")
    api32 = build_model(cfg32)
    params32 = api32.init_params(0)
    batch32 = {"tokens": tokens[:JAMBA_F32_PROMPT[0], :JAMBA_F32_PROMPT[1]]}
    _, pre32 = _family_prefill(
        api32, params32, batch32, counted, wrappers, expect,
        {"ssd_scan": "f32-core", "flash_attention": "f32-core"})
    for kernel, n in expect.items():
        _count(counters, kernel, "serve_hybrid.f32", n)
    row["f32"] = dict(pre32, prompt=list(batch32["tokens"].shape))
    # capacity_factor 8: no token drops in the 64-token prefill nor in a
    # one-token step; SSD chunk 64, since a prefill's length is a multiple
    # of the chunk
    cf8 = build_model(cfg32.with_overrides(
        moe=dataclasses.replace(cfg.moe, capacity_factor=8.0),
        ssm=dataclasses.replace(cfg.ssm, chunk=64)))
    prompt = tokens[:, :64]
    with _moe_routes() as rec:
        pre = cf8.prefill(params32, {"tokens": prompt})
    check(all(bool(k.all()) for k in rec["keep"]), "a token dropped at "
          "capacity_factor 8")
    dec = _teacher_forced(cf8, params32, cf8.init_decode_cache(2, 64), prompt)
    tf = float((dec - pre).abs().max())
    check(tf <= FAMILY_BANDS[arch]["float32"]
          and torch.equal(dec.argmax(-1), pre.argmax(-1)),
          f"Jamba teacher-forced decode vs prefill: {tf}")
    row["teacher_forced"] = dict(tokens=64, logits_max_abs_diff=tf,
                                 band=FAMILY_BANDS[arch]["float32"],
                                 logits_abs_max=float(pre.abs().max()))
    row["f32_max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del params32
    _free()
    emit("serve_hybrid", arch=arch, **row, nvidia_smi=nvidia_smi())
    return row


def phase_serve_encdec(counters: dict) -> dict:
    """whisper-medium at full width and depth: 24 encoder and 24 decoder
    layers over 1,500 seeded frames."""
    import torch
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.models import build_model
    wrappers, counted = _serve_setup()
    (arch, layers, n_params), = FAMILY_CELLS["serve_encdec"]
    cfg = _family_config(arch, layers)
    api = build_model(cfg)
    params, row = _family_params(api, n_params)
    tokens = _tokens(cfg, FAMILY_PROMPT[arch])
    gen = torch.Generator(device="cuda").manual_seed(2)
    frames = torch.randn((tokens.shape[0], cfg.encoder_seq, cfg.d_model),
                         generator=gen, device="cuda")
    batch = {"frame_embeds": frames.to(torch.bfloat16), "tokens": tokens}
    row["warmup_s"] = _timed(lambda: api.prefill(params, batch))
    logits, pre = _family_prefill(
        api, params, batch, counted, wrappers,
        {"flash_attention": cfg.n_layers},
        {"flash_attention": "tensor-core"}, floor="flash")
    _count(counters, "flash_attention", "serve_encdec", cfg.n_layers)
    row.update(pre, layers=cfg.n_layers, encoder_layers=cfg.n_encoder_layers,
               d_model=cfg.d_model, prompt=list(tokens.shape),
               frames=list(frames.shape),
               prefill_tokens_per_s=tokens.numel() / pre["prefill_s"])
    # the encoder (1,500 frames) and cross-attention take plain_attention
    # by the reference's rule, and so does a 1,024-token decoder
    short, t_short, launches = counted(lambda: api.prefill(
        params, {**batch, "tokens": tokens[:, :1024]}))
    check(not any(launches.values()) and bool(torch.isfinite(short).all()),
          f"1,024-token decoder prefill launched {launches}")
    row.update(short_prefill_s=t_short, short_prefill_launches=0)
    # 31 greedy steps against memory filled from encode
    cache = _fill_memory(api, params,
                         api.init_decode_cache(tokens.shape[0], 32),
                         batch["frame_embeds"])
    dec, t_dec, launches = counted(lambda: greedy_decode(
        api, params, cache, logits, 0, 31))
    check(not any(launches.values()) and bool(torch.isfinite(dec).all()),
          f"Whisper greedy decode launched {launches}")
    row.update(greedy_decode_ms_per_step=t_dec / 31 * 1e3,
               **_idle_probe(api, params, logits))
    row.update(_serve_main(counted, arch))
    row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del params, cache
    _free()
    api32 = build_model(cfg.with_overrides(dtype="float32"))
    params32 = api32.init_params(0)
    batch32 = {"frame_embeds": frames, "tokens": tokens}
    _, pre32 = _family_prefill(
        api32, params32, batch32, counted, wrappers,
        {"flash_attention": cfg.n_layers}, {"flash_attention": "f32-core"})
    _count(counters, "flash_attention", "serve_encdec.f32", cfg.n_layers)
    row["f32"] = pre32
    prompt = tokens[:, :64]
    pre = api32.prefill(params32, {"frame_embeds": frames, "tokens": prompt})
    cache = _fill_memory(api32, params32,
                         api32.init_decode_cache(tokens.shape[0], 64), frames)
    dec = _teacher_forced(api32, params32, cache, prompt)
    tf = float((dec - pre).abs().max())
    check(tf <= FAMILY_BANDS[arch]["float32"]
          and torch.equal(dec.argmax(-1), pre.argmax(-1)),
          f"Whisper teacher-forced decode vs prefill: {tf}")
    row["teacher_forced"] = dict(tokens=64, logits_max_abs_diff=tf,
                                 band=FAMILY_BANDS[arch]["float32"],
                                 logits_abs_max=float(pre.abs().max()))
    del params32, cache
    _free()
    emit("serve_encdec", arch=arch, **row, nvidia_smi=nvidia_smi())
    return row


def phase_serve_vlm(counters: dict) -> dict:
    """phi-3-vision-4.2b at full width and depth: 576 seeded patch
    embeddings before 3,520 tokens, head dim 96."""
    import torch
    from repro_torch.models import build_model
    wrappers, counted = _serve_setup()
    (arch, layers, n_params), = FAMILY_CELLS["serve_vlm"]
    cfg = _family_config(arch, layers)
    api = build_model(cfg)
    params, row = _family_params(api, n_params)
    tokens = _tokens(cfg, FAMILY_PROMPT[arch])
    gen = torch.Generator(device="cuda").manual_seed(3)
    patches = torch.randn((tokens.shape[0], cfg.n_patches, cfg.d_model),
                          generator=gen, device="cuda")
    batch = {"patch_embeds": patches.to(torch.bfloat16), "tokens": tokens}
    row["warmup_s"] = _timed(lambda: api.prefill(params, batch))
    logits, pre = _family_prefill(
        api, params, batch, counted, wrappers,
        {"flash_attention": cfg.n_layers},
        {"flash_attention": "tensor-core"}, floor="flash")
    _count(counters, "flash_attention", "serve_vlm", cfg.n_layers)
    positions = tokens.shape[1] + cfg.n_patches
    row.update(pre, layers=cfg.n_layers, d_model=cfg.d_model,
               head_dim=cfg.resolved_head_dim(), prompt=list(tokens.shape),
               patches=list(patches.shape), positions=positions,
               prefill_tokens_per_s=tokens.shape[0] * positions
               / pre["prefill_s"])
    row.update(_idle_probe(api, params, logits))
    row.update(_serve_main(counted, arch))
    row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del params
    _free()
    api32 = build_model(cfg.with_overrides(dtype="float32"))
    params32 = api32.init_params(0)
    _, pre32 = _family_prefill(
        api32, params32, {"patch_embeds": patches,
                          "tokens": tokens[:, :VLM_F32_TOKENS]},
        counted, wrappers, {"flash_attention": cfg.n_layers},
        {"flash_attention": "f32-core"})
    _count(counters, "flash_attention", "serve_vlm.f32", cfg.n_layers)
    row["f32"] = dict(pre32, prompt=[tokens.shape[0], VLM_F32_TOKENS])
    del params32
    _free()
    emit("serve_vlm", arch=arch, **row, nvidia_smi=nvidia_smi())
    return row


# ------------------------------------------------------------------ train

#: the training cells: (arch, layers (None: published depth), global
#: batch, seq, microbatches, steps).  tinyllama's train_4k batch of 256
#: is cut to 4 (three steps fit the script's time); mamba2-780m's 48
#: layers to 8, its batch to 2
TRAIN_CELLS = {"dense": ("tinyllama-1.1b", None, 4, 4096, 2, 3),
               "ssm": ("mamba2-780m", 8, 2, 4096, 1, 2)}
#: |kernel route - force="torch"| of one microbatch's train_loss and
#: gradients, bf16: the loss within the serving band of SERVE_CELLS; the
#: global gradient norm (relative) and each layer's attention projection
#: (tinyllama) or mixer (mamba2) gradients (max |diff| over max |g|)
#: within a band set beside the floor an H100 showed (the plain run
#: against itself at flash block 256 / half the SSD chunk): tinyllama's
#: norm 1.86e-5 (kernel 6.07e-5), layers 6.29e-3 (6.49e-3); mamba2's
#: norm 1.62e-4 (kernel 2.03e-3: its tensor-core forward differs from the
#: plain one by up to 4.6e-4 before the backward), layers 0.0584
#: (0.0606).  Bands: about three times the larger of the two, rounded up.
#: f32 at 4 layers: 1e-4 relative (4.1e-7 seen).  PERF.md "Parity bands"
TRAIN_BANDS = {"tinyllama-1.1b": {"loss": SERVE_CELLS["serve"][2]["bfloat16"],
                                  "grad_norm": 2e-4, "attn": 0.02},
               "mamba2-780m": {"loss": SERVE_CELLS["serve_ssm"][2]["bfloat16"],
                               "grad_norm": 7e-3, "mixer": 0.2}}
TRAIN_F32_REL = 1e-4
#: the flash Function's torch.equal check: q [b, s, h, hd], k/v
#: [b, s, kv, hd] (tinyllama's microbatch)
TRAIN_FLASH_FN = (2, 4096, 32, 4, 64)
#: the fault-tolerance cell: smoke-size qwen2-1.5b (f32), 8 steps
TRAIN_FT = ("qwen2-1.5b", 32, 2)


def _train_grads(api, params, batch, force=None):
    """(loss, {name: grad}) of ``api.train_loss`` on ``batch``, through
    the dispatch ``force`` (the grads in the params' dtype)."""
    from repro_torch.train.step import value_and_grad
    from repro_torch.utils.tree import flatten_with_names
    loss, _, grads = value_and_grad(api, params, batch, force=force)
    return loss, dict(flatten_with_names(grads))


def _grad_norm(grads) -> float:
    import torch
    return float(torch.sqrt(sum(torch.sum(g.float() ** 2)
                                for g in grads.values())))


def _grad_diffs(a, b, pattern) -> dict:
    """Run ``a`` against ``b`` (each (loss, grads)): the loss's and the
    global gradient norm's relative differences, and per layer the max
    |a - b| over the leaves whose name matches ``pattern`` relative to
    their max |b|."""
    import re
    la, ga = a
    lb, gb = b
    per_layer: dict = {}
    for n, g in gb.items():
        m = re.match(r"layers/(\d+)/" + pattern, n)
        if m:
            i = int(m.group(1))
            d = float((ga[n].float() - g.float()).abs().max())
            s = float(g.float().abs().max())
            prev = per_layer.get(i, (0.0, 0.0))
            per_layer[i] = (max(prev[0], d), max(prev[1], s))
    rel = [d / s if s else d for _, (d, s) in sorted(per_layer.items())]
    norm_b = _grad_norm(gb)
    return dict(loss=float(la), loss_diff=abs(float(la) - float(lb)),
                loss_rel=abs(float(la) - float(lb)) / abs(float(lb)),
                grad_norm=_grad_norm(ga),
                grad_norm_rel=abs(_grad_norm(ga) - norm_b) / norm_b,
                layer_rel=rel, layer_rel_max=max(rel))


def _train_parity(api, params, batch, floor, pattern, counted, wrappers,
                  kernel, expect):
    """One microbatch through ``train_loss`` and ``backward``: the kernel
    route (``kernel`` launched ``expect`` times, forward and recompute)
    against ``force="torch"``, and the floor (``floor()``: the plain run
    at flash block 256 or half the SSD chunk) against it."""
    (k_out, t_kernel, launches) = counted(
        lambda: _train_grads(api, params, batch))
    check(launches == {**dict.fromkeys(wrappers, 0), kernel: expect},
          f"{api.cfg.name} train_loss backward launched {launches}, "
          f"expected {expect} {kernel}")
    p_out, t_plain, p_launches = counted(
        lambda: _train_grads(api, params, batch, force="torch"))
    check(not any(p_launches.values()), f"force='torch' launched "
          f"{p_launches}")
    row = dict(kernel_vs_plain=_grad_diffs(k_out, p_out, pattern),
               kernel_s=t_kernel, plain_s=t_plain)
    del k_out
    if floor is not None:
        f_out = floor()
        row["floor_vs_plain"] = _grad_diffs(f_out, p_out, pattern)
    return row


def _train_band_check(name, row, bands, key):
    kv = row["kernel_vs_plain"]
    check(kv["loss_diff"] <= bands["loss"],
          f"{name}: loss differs by more than {bands['loss']}: {kv}")
    for what, band in (("grad_norm_rel", bands["grad_norm"]),
                       ("layer_rel_max", bands[key])):
        if band is not None:
            check(kv[what] <= band, f"{name}: {what} {kv[what]} over its "
                  f"band {band} (floor {row.get('floor_vs_plain')})")


def _timed_manager(record):
    """A ``CheckpointManager`` whose saves block, each timed into
    ``record`` with its step."""
    from repro_torch.checkpoint import CheckpointManager

    class Timed(CheckpointManager):
        def save(self, step, tree, metadata=None, blocking=False):
            t0 = time.perf_counter()
            out = super().save(step, tree, metadata, blocking=True)
            record.append((step, time.perf_counter() - t0))
            return out
    return Timed


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _train_cell(cell, counted, wrappers, kernel, tmp):
    """``run_training`` of a TRAIN_CELLS cell on the card: the main path
    (``kernel`` launched once a layer for each microbatch's forward and
    once for its recompute), its times, the one checkpoint save, peak
    memory."""
    import shutil
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import LoopConfig, loop, run_training
    arch, layers, batch, seq, mb, steps = TRAIN_CELLS[cell]
    cfg = _family_config(arch, layers)
    api = build_model(cfg)
    shape = ShapeConfig(f"train_{seq}", seq_len=seq, global_batch=batch,
                        kind="train")
    ocfg = AdamWConfig(lr_peak=3e-4, warmup_steps=2, total_steps=steps)
    ck = os.path.join(tmp, cell)
    per_step = cfg.n_layers * 2 * mb
    n_params = sum(t.numel() for t in _leaves(api.init_params(0)))
    _free()
    need = n_params * (2 + 3 * 4)          # bf16 params, f32 master / m / v
    free = shutil.disk_usage(tmp).free
    check(free > 1.2 * need, f"{arch}: the checkpoint needs ~{need / 1e9:.1f}"
          f" GB and {free / 1e9:.1f} GB are free under {tmp}")
    saves: list = []
    real = loop.CheckpointManager
    loop.CheckpointManager = _timed_manager(saves)
    torch.cuda.reset_peak_memory_stats()
    try:
        res, seconds, launches = counted(lambda: run_training(
            api, shape, ocfg, LoopConfig(steps=steps, ckpt_dir=ck,
                                         ckpt_every=steps, microbatches=mb)))
    finally:
        loop.CheckpointManager = real
    peak = torch.cuda.max_memory_allocated()
    check(launches == {**dict.fromkeys(wrappers, 0),
                       kernel: per_step * steps},
          f"{arch} training launched {launches}, expected {per_step} "
          f"{kernel} a step")
    route = wrappers[kernel].last_route
    check(route == "tensor-core", f"{arch} trained on the {route} route")
    check(len(res.losses) == steps and all(map(math.isfinite, res.losses)),
          f"{arch} losses {res.losses}")
    check([s for s, _ in saves] == [steps], f"{arch} saves {saves}")
    timed = res.step_times[1:]
    ms = sum(timed) / len(timed) * 1e3
    row = dict(arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
               dtype=cfg.dtype, params=n_params, batch=batch, seq=seq,
               microbatches=mb, steps=steps, losses=res.losses,
               step_s=res.step_times, ms_per_step=ms,
               tokens_per_s=batch * seq / (ms / 1e3),
               launches={kernel: launches[kernel]},
               launches_per_step={kernel: per_step}, route=route,
               max_memory_allocated=peak, run_s=seconds,
               ckpt_save_s=saves[0][1], ckpt_bytes=_dir_bytes(ck),
               disk_free_bytes=free, stragglers=len(res.straggler_events))
    shutil.rmtree(ck, ignore_errors=True)
    return api, shape, ocfg, row, launches[kernel]


def _train_idle(api, shape, ocfg, mb) -> dict:
    """``_step_idle`` of one ``make_train_step`` step of (a)."""
    from repro_torch.data import device_batch
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    params = api.init_params(0)
    opt = adamw_init(params)
    step = make_train_step(api, ocfg, mb)
    batch = device_batch(api.cfg, shape, 0)
    row = _step_idle(lambda: step(params, opt, batch))
    del params, opt
    _free()
    return row


def _step_idle(fn) -> dict:
    """Device idle share of one training step ``fn()`` (1 - device busy
    time from a device-only trace / the wall of the same step
    unprofiled) and its device operations by kind."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    wall_us = _timed(fn) * 1e6
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.duration_ns() for e in events) / 1e3
    by_kind: dict = {}
    for e in events:
        kind = _kernel_kind(e.name())
        us, n = by_kind.get(kind, (0.0, 0))
        by_kind[kind] = (us + e.duration_ns() / 1e3, n + 1)
    return dict(idle_step_wall_us=wall_us, idle_step_device_busy_us=busy_us,
                device_idle_share=1.0 - busy_us / wall_us,
                device_ops_per_step=len(events),
                device_us_by_kind={k: {"us": us, "ops": n} for k, (us, n)
                                   in sorted(by_kind.items(),
                                             key=lambda kv: -kv[1][0])},
                idle_probe_s=time.perf_counter() - t0)


def _kernel_kind(name: str) -> str:
    """A device operation's family, for a step's time by kind: the flash
    kernel, cuBLAS / CUTLASS products, copies and fills, reductions, and
    the elementwise rest."""
    low = name.lower()
    for kind, keys in (("flash_attention", ("flash_fwd",)),
                       ("ssd_scan", ("ssd_",)),
                       ("matmul", ("gemm", "sm90_xmma", "cutlass", "cublas",
                                   "splitk", "kernel2")),
                       ("copy_fill", ("memcpy", "memset", "copy", "fill")),
                       ("reduce", ("reduce", "softmax", "norm", "cumsum",
                                   "scan"))):
        if any(k in low for k in keys):
            return kind
    return "elementwise_other"


def _function_equal(kernel, shape_args, gen):
    """The kernel's autograd Function against the plain version at the
    path shape: the gradients of every input are ``torch.equal``."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    if kernel == "flash_attention":
        b, s, h, kv, hd = shape_args
        ins = [torch.randn(sh, generator=gen, device="cuda").to(
            torch.bfloat16).requires_grad_() for sh in
            ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]

        def run(force):
            return fops.flash_attention(*ins, causal=True, block_q=512,
                                        block_k=512, force=force)
    else:
        b, l, h, p, g, n, chunk = shape_args
        x = torch.randn((b, l, h, p), generator=gen, device="cuda")
        dt = torch.rand((b, l, h), generator=gen, device="cuda") * 0.1
        dA = -dt * torch.rand((h,), generator=gen, device="cuda")
        B = torch.randn((b, l, g, n), generator=gen, device="cuda")
        C = torch.randn((b, l, g, n), generator=gen, device="cuda")
        ins = [x.to(torch.bfloat16).requires_grad_(), dt.requires_grad_(),
               dA.requires_grad_(), B.to(torch.bfloat16).requires_grad_(),
               C.to(torch.bfloat16).requires_grad_()]

        def run(force):
            return sops.ssd_scan(*ins, chunk=chunk, force=force)
    out = run(None)
    outs = out if isinstance(out, tuple) else (out,)
    cot = [torch.randn(o.shape, generator=gen, device="cuda").to(o.dtype)
           for o in outs]
    got = torch.autograd.grad(outs, ins, cot)
    plain = run("torch")
    plains = plain if isinstance(plain, tuple) else (plain,)
    want = torch.autograd.grad(plains, ins, cot)
    same = [bool(torch.equal(a, b_)) for a, b_ in zip(got, want)]
    check(all(same), f"{kernel} Function gradients != plain: {same}")
    out_diff = max(float((o - p).detach().float().abs().max())
                   for o, p in zip(outs, plains))
    return dict(shape=list(shape_args), grads_equal=same,
                forward_max_abs_diff=out_diff)


#: part (f): tinyllama-1.1b's (a) weights and global batch (4 x 4,096) on
#: a (pod, data) mesh of the one card, one sequence a shard, compressed
#: cross-pod reduction
TRAIN_DP_MESH = (2, 2)
TRAIN_DP_STEPS = 3
#: part (g): the reference's toy (tests/test_dp_compressed.py) on (2, 4)
TRAIN_TOY_MESH = (2, 4)
TRAIN_TOY_STEPS = 150
#: the two LM examples, run as children beside (d) and (e): argv, the
#: lines their output must hold
TRAIN_EXAMPLES = {
    "serve_demo": (["examples/torch_serve_demo.py"],
                   ("decoded 16 tokens x batch 4",)),
    "train_smoke": (["examples/torch_train_smoke.py"],
                    ("injected crash at step 20", "steps=30 resumed_from=20",
                     "loss: ")),
}


def _examples_start(env) -> dict:
    return {name: subprocess.Popen(
        [sys.executable, *argv], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for name, (argv, _) in TRAIN_EXAMPLES.items()}


def _examples_join(kids) -> dict:
    """Each example's exit, its lines checked; its output lines."""
    out = {}
    for name, kid in kids.items():
        stdout, stderr = kid.communicate(timeout=300)
        want = TRAIN_EXAMPLES[name][1]
        check(kid.returncode == 0 and all(w in stdout for w in want),
              f"examples/torch_{name}.py exit {kid.returncode}: "
              f"{stdout[-800:]} {stderr[-2000:]}")
        out[name] = [ln for ln in stdout.splitlines() if ln.strip()][:8]
    return out


def _dp_step(api, mesh, ocfg, force=None):
    from repro_torch.train import make_dp_train_step
    return make_dp_train_step(
        lambda p, b: api.train_loss(p, b, force=force)[0], mesh, ocfg,
        stacked=api.stacked_name)


def _dp_run(step, params, opt, err, batch, pattern):
    """One data-parallel step, recording pod 0's intra-pod-reduced
    gradients before the compression: (the step's outputs, the record
    {"loss", "grads": the leaves matching ``pattern``, "norm": their
    global norm, "step_norm": the step's post-compression norm})."""
    import re
    import torch
    from repro_torch.train import dp
    from repro_torch.utils.tree import flatten_with_names
    real, rec = dp.compressed_psum, {}

    def capture(grads, *a, **kw):
        flat = flatten_with_names(grads[0])
        rec["norm"] = float(torch.sqrt(sum(torch.sum(g.float() ** 2)
                                           for _, g in flat)))
        rec["grads"] = {n: g.clone() for n, g in flat
                        if re.match(r"layers/\d+/" + pattern, n)}
        return real(grads, *a, **kw)
    dp.compressed_psum = capture
    try:
        out = step(params, opt, err, batch)
    finally:
        dp.compressed_psum = real
    rec.update(loss=out[3], step_norm=float(out[4]))
    return out, rec


def _dp_parity(api, mesh, ocfg, params, opt, err, batch, kernel_rec,
               counted, pattern):
    """The first data-parallel step with the kernels (``kernel_rec``, from
    ``_dp_run``) against the same step under ``force="torch"`` and its
    floor (plain at flash block 256): the loss, pod 0's pre-compression
    gradients (global norm, per-layer ``pattern`` leaves) for (b)'s
    bands, and the step's post-compression gradient norms beside them."""
    (_, plain), t_p, p_launches = counted(lambda: _dp_run(
        _dp_step(api, mesh, ocfg, "torch"), params, opt, err, batch,
        pattern))
    check(not any(p_launches.values()), f"force='torch' launched "
          f"{p_launches}")
    with _flash_block(256):
        _, floor = _dp_run(_dp_step(api, mesh, ocfg, "torch"), params, opt,
                           err, batch, pattern)

    def diffs(a):
        row = _grad_diffs((a["loss"], a["grads"]),
                          (plain["loss"], plain["grads"]), pattern)
        row.update(grad_norm=a["norm"], grad_norm_rel=abs(
            a["norm"] - plain["norm"]) / plain["norm"],
            step_grad_norm=a["step_norm"], step_grad_norm_rel=abs(
                a["step_norm"] - plain["step_norm"]) / plain["step_norm"])
        return row
    return dict(kernel_vs_plain=diffs(kernel_rec),
                floor_vs_plain=diffs(floor), plain_s=t_p)


def _dp_pieces(api, mesh, params, batch, err) -> dict:
    """Device ms of the data-parallel step's reductions, each from a trace
    of the device alone on one shard's real gradient: a pod's intra-pod
    ``pmean`` of ``data`` members and the compressed cross-pod
    reduction over ``pod`` members (with the run's per-pod residuals);
    their bounds (each input read once, each output written once)."""
    from repro_torch.optim import compressed_psum
    from repro_torch.train import dp
    from repro_torch.train.step import value_and_grad
    n_pod, n_data = mesh.devices.shape
    rows = batch["tokens"].shape[0] // mesh.size
    _, _, g = value_and_grad(api, params,
                             {k: v[:rows] for k, v in batch.items()})
    n = sum(t.numel() for t in _leaves(params))
    pod = dp.pmean([g] * n_data)
    intra_us = _device_busy_us(lambda: dp.pmean([g] * n_data))
    comp_us = _device_busy_us(lambda: compressed_psum(
        [pod] * n_pod, err, api.stacked_name))
    check(intra_us is not None and comp_us is not None,
          "the reductions' device trace is empty")
    # bf16 members in, the bf16 mean out; bf16 pod means and f32
    # residuals in, the f32 mean and the new residuals out
    intra_b = n * 2 * (n_data + 1)
    comp_b = n * (n_pod * (2 + 4 + 4) + 4)
    return dict(params=n, intra_pod_pmean_device_ms=intra_us / 1e3,
                intra_pod_pmean_per_step_ms=n_pod * intra_us / 1e3,
                intra_pod_bound_ms=intra_b / HBM_BYTES_PER_S * 1e3,
                compressed_psum_device_ms=comp_us / 1e3,
                compressed_psum_bound_ms=comp_b / HBM_BYTES_PER_S * 1e3,
                compressed_psum_bytes_bound=comp_b,
                reductions_per_step_device_ms=(n_pod * intra_us + comp_us)
                / 1e3)


def _train_dp(api, shape, ocfg, counted, wrappers, kernel, counters) -> dict:
    """Part (f): data-parallel training at full width (``train.dp``)."""
    import torch
    from repro_torch.data import device_batch
    from repro_torch.launch.mesh import _make_mesh
    from repro_torch.train import init_dp_state
    mesh = _make_mesh(TRAIN_DP_MESH, ("pod", "data"), api.device)
    per_step = api.cfg.n_layers * 2 * mesh.size
    step = _dp_step(api, mesh, ocfg)
    _free()
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(0)
    opt, err = init_dp_state(params)
    losses, times, launched = [], [], 0
    pods_differ = kernel_rec = None
    pattern = r"attn/w[qkvo]"
    for i in range(TRAIN_DP_STEPS):
        batch = device_batch(api.cfg, shape, i, api.device)
        if i == 0:       # the parity's kernel step: its gradients recorded
            (out, kernel_rec), sec, launches = counted(
                lambda: _dp_run(step, params, opt, err, batch, pattern))
        else:
            out, sec, launches = counted(
                lambda: step(params, opt, err, batch))
        params, opt, err, loss, _ = out
        del out
        check(launches == {**dict.fromkeys(wrappers, 0), kernel: per_step},
              f"data-parallel step {i} launched {launches}, expected "
              f"{per_step} {kernel}")
        launched += launches[kernel]
        losses.append(float(loss))
        times.append(sec)
        if i == 0:
            pods_differ = sum(int((a != b).sum()) for a, b in zip(
                _leaves(err[0]), _leaves(err[1])))
    peak = torch.cuda.max_memory_allocated()
    check(all(map(math.isfinite, losses)), f"data-parallel losses {losses}")
    check(isinstance(err, list) and len(err) == TRAIN_DP_MESH[0]
          and pods_differ > 0, f"err_state after step 1: "
          f"{pods_differ} elements differ between the pods")
    _count(counters, kernel, "train.dp", launched)
    ms = sum(times[1:]) / len(times[1:]) * 1e3
    tokens = shape.global_batch * shape.seq_len
    row = dict(mesh=dict(zip(("pod", "data"), TRAIN_DP_MESH)),
               shard_batch=[shape.global_batch // mesh.size, shape.seq_len],
               steps=TRAIN_DP_STEPS, losses=losses, step_s=times,
               ms_per_step=ms, tokens_per_s=tokens / (ms / 1e3),
               launches={kernel: launched},
               launches_per_step={kernel: per_step},
               route=wrappers[kernel].last_route, max_memory_allocated=peak,
               err_elements_differing_between_pods=pods_differ)
    check(row["route"] == "tensor-core", f"data-parallel route "
          f"{row['route']}")
    batch = device_batch(api.cfg, shape, 0, api.device)
    row.update(_dp_pieces(api, mesh, params, batch, err))
    row.update(_step_idle(lambda: step(params, opt, err, batch)))
    del params, opt, err
    _free()
    # the first step again from (a)'s init, under force="torch"
    params = api.init_params(0)
    opt, err = init_dp_state(params)
    par = _dp_parity(api, mesh, ocfg, params, opt, err, batch, kernel_rec,
                     counted, pattern)
    par["kernel_s"] = times[0]
    del params, opt, err, kernel_rec
    _free()
    _train_band_check("tinyllama-1.1b data-parallel", par,
                      TRAIN_BANDS["tinyllama-1.1b"], "attn")
    row["parity"] = par
    return row


def _train_toy(dev="cuda") -> dict:
    """Part (g): the reference's least-squares test of the compressed
    trainer (``tests/test_dp_compressed.py``) on the card."""
    import torch
    from repro_torch.launch.mesh import _make_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_dp_state, make_dp_train_step
    mesh = _make_mesh(TRAIN_TOY_MESH, ("pod", "data"), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    w_true = torch.randn((16, 32), generator=gen, device=dev) * 0.5
    ocfg = AdamWConfig(lr_peak=3e-2, warmup_steps=5,
                       total_steps=TRAIN_TOY_STEPS, weight_decay=0.0)

    def loss_fn(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)
    losses, seconds = {}, {}
    for compress in (False, True):
        t0 = time.perf_counter()
        p = {"w": torch.zeros((16, 32), device=dev)}
        opt, err = init_dp_state(p)
        step = make_dp_train_step(loss_fn, mesh, ocfg,
                                  compress_cross_pod=compress)
        data = torch.Generator(device=dev).manual_seed(1)
        for _ in range(TRAIN_TOY_STEPS):
            x = torch.randn((64, 16), generator=data, device=dev)
            y = x @ w_true + 0.01 * torch.randn((64, 32), generator=data,
                                                device=dev)
            p, opt, err, loss, _ = step(p, opt, err, {"x": x, "y": y})
        losses[compress] = float(loss)
        seconds[compress] = time.perf_counter() - t0
    check(losses[True] < 0.01 and abs(losses[True] - losses[False]) < 0.01,
          f"compressed data-parallel toy: {losses}")
    return dict(mesh=list(TRAIN_TOY_MESH), steps=TRAIN_TOY_STEPS,
                final_loss={"compressed": losses[True],
                            "uncompressed": losses[False]},
                seconds={"compressed": seconds[True],
                         "uncompressed": seconds[False]})


def _train_moe_rules() -> dict:
    """Part (h): an MoE model's value and gradient under ``use_rules``
    with per-layer remat.  The checkpoint's recompute runs on autograd's
    device thread, which does not see the rules; the dispatch shards are
    read outside it, so the run equals the one without remat."""
    from repro_torch.configs import get_config, smoke_reduce
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import device_batch
    from repro_torch.models import build_model
    from repro_torch.sharding import use_rules
    from repro_torch.train.step import value_and_grad
    from repro_torch.utils.tree import flatten_with_names
    t0 = time.perf_counter()
    cfg = smoke_reduce(get_config("moonshot-v1-16b-a3b")).with_overrides(
        n_layers=2, dtype="float32")
    shape = ShapeConfig("moe", seq_len=32, global_batch=4, kind="train")
    batch = device_batch(cfg, shape, 0)
    runs = {}
    for name, policy, shards in (("remat", "nothing_saveable", 2),
                                 ("plain", "none", 2),
                                 ("one_shard", "nothing_saveable", 1)):
        api = build_model(cfg.with_overrides(remat_policy=policy))
        with use_rules(None, {"dp_shards": shards}):
            runs[name] = value_and_grad(api, api.init_params(0), batch)
    (loss, m, g), (p_loss, p_m, p_g) = runs["remat"], runs["plain"]
    p_flat = dict(flatten_with_names(p_g))
    grad_rel = max(float((a - p_flat[n]).abs().max())
                   / max(float(p_flat[n].abs().max()), 1e-30)
                   for n, a in flatten_with_names(g))
    rel = dict(loss=abs(float(loss) / float(p_loss) - 1),
               aux=abs(float(m["aux"]) / float(p_m["aux"]) - 1),
               grad_max=grad_rel)
    one_aux = float(runs["one_shard"][1]["aux"])
    check(max(rel.values()) <= 1e-5, f"MoE remat under rules: {rel}")
    check(float(m["aux"]) != one_aux, "MoE under rules: aux equals the "
          "one-shard run's")
    return dict(arch="moonshot-v1-16b-a3b", n_layers=2, dtype="float32",
                dp_shards=2, remat_vs_plain_rel=rel,
                aux={"two_shards": float(m["aux"]), "one_shard": one_aux},
                seconds=time.perf_counter() - t0)


def _with_flash_block(block, fn):
    with _flash_block(block):
        return fn()


def phase_train(counters: dict) -> dict:
    """Training on the card (``repro_torch.train``): the main path of its
    slice, every kernel count set to 0 just before each run and read just
    after."""
    import tempfile
    import torch
    from repro_torch.configs import get_config, smoke_reduce
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import device_batch
    from repro_torch.kernels.ssd_scan.kernel import LAUNCHES_PER_CALL
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import LoopConfig, run_training
    wrappers, counted = _serve_setup()
    row: dict = {}
    tmp_dir = tempfile.TemporaryDirectory(prefix="train_")
    tmp = tmp_dir.name
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "tinyllama-1.1b", "--reduced", "--steps", "4", "--ckpt-dir",
         os.path.join(tmp, "cli")], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    examples = _examples_start(env)
    try:
        # (d) fault tolerance at smoke size, while the CLI child runs
        t0 = time.perf_counter()
        arch, seq, batch = TRAIN_FT
        api = build_model(smoke_reduce(get_config(arch)))
        shape = ShapeConfig("ft", seq_len=seq, global_batch=batch,
                            kind="train")
        ocfg = AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=8)
        full = run_training(api, shape, ocfg, LoopConfig(
            steps=8, ckpt_dir=os.path.join(tmp, "ft_a"), ckpt_every=4))
        lcfg = LoopConfig(steps=8, ckpt_dir=os.path.join(tmp, "ft_b"),
                          ckpt_every=4)
        try:
            run_training(api, shape, ocfg, lcfg, crash_at_step=6)
            check(False, "the injected crash did not happen")
        except RuntimeError as e:
            check("injected crash at step 6" in str(e), str(e))
        resumed = run_training(api, shape, ocfg, lcfg)
        check(resumed.resumed_from == 4, f"resumed from "
              f"{resumed.resumed_from}")
        check(full.losses[4:] == resumed.losses, f"resumed losses "
              f"{resumed.losses} != {full.losses[4:]}")
        row["fault_tolerance"] = dict(
            arch=arch, seq=seq, batch=batch, losses=full.losses,
            resumed_losses=resumed.losses, resumed_from=4, equal="exact",
            seconds=time.perf_counter() - t0)
        # (e) the CLI
        out, err = cli.communicate(timeout=300)
        check(cli.returncode == 0 and "done: steps=4" in out,
              f"launch.train exit {cli.returncode}: {out[-500:]} "
              f"{err[-2000:]}")
        row["cli"] = [ln for ln in out.splitlines() if ln.startswith(
            ("training", "done:"))]
        row["examples"] = _examples_join(examples)

        # (a) tinyllama-1.1b at full width and depth
        kernel = "flash_attention"
        api, shape, ocfg, cell, n = _train_cell("dense", counted, wrappers,
                                                kernel, tmp)
        _count(counters, kernel, "train", n)
        cell.update(_train_idle(api, shape, ocfg, TRAIN_CELLS["dense"][4]))
        row["dense"] = cell
        # (b) gradient parity of one microbatch of (a)'s first batch
        params = api.init_params(0)
        mb = {k: v[:2] for k, v in device_batch(api.cfg, shape, 0).items()}
        floor = lambda: _with_flash_block(  # noqa: E731
            256, lambda: _train_grads(api, params, mb, force="torch"))
        par = _train_parity(api, params, mb, floor, r"attn/w[qkvo]",
                            counted, wrappers, kernel,
                            api.cfg.n_layers * 2)
        del params
        _free()
        cfg32 = api.cfg.with_overrides(dtype="float32", n_layers=4)
        api32 = build_model(cfg32)
        params32 = api32.init_params(0)
        par["f32"] = _train_parity(api32, params32, mb, None,
                                   r"attn/w[qkvo]", counted, wrappers,
                                   kernel, cfg32.n_layers * 2)
        f32 = par["f32"]["kernel_vs_plain"]
        check(max(f32["loss_rel"], f32["grad_norm_rel"],
                  f32["layer_rel_max"]) <= TRAIN_F32_REL,
              f"f32 kernel vs plain beyond {TRAIN_F32_REL}: {f32}")
        del params32
        _free()
        gen = torch.Generator(device="cuda").manual_seed(5)
        par["function"] = _function_equal(kernel, TRAIN_FLASH_FN, gen)
        row["dense_parity"] = par
        _train_band_check("tinyllama-1.1b", par,
                          TRAIN_BANDS["tinyllama-1.1b"], "attn")

        # (f) data-parallel training of (a)'s model on a (pod, data) mesh
        t0 = time.perf_counter()
        row["data_parallel"] = _train_dp(api, shape, ocfg, counted, wrappers,
                                         kernel, counters)
        row["data_parallel"]["seconds"] = time.perf_counter() - t0
        # (g) the reference's compressed toy on a (2, 4) mesh
        row["dp_toy"] = _train_toy()
        # (h) an MoE model trained under rules, with remat
        row["moe_rules"] = _train_moe_rules()

        # (c) mamba2-780m at full width, 8 layers
        kernel = "ssd_scan"
        arch = TRAIN_CELLS["ssm"][0]
        api, shape, ocfg, cell, n = _train_cell("ssm", counted, wrappers,
                                                kernel, tmp)
        _count(counters, kernel, "train", n)
        cell["cuda_launches_per_call"] = LAUNCHES_PER_CALL[cell["route"]]
        row["ssm"] = cell
        params = api.init_params(0)
        mb = device_batch(api.cfg, shape, 0)
        half = _half_chunk(api)
        floor = lambda: _train_grads(half, params, mb,  # noqa: E731
                                     force="torch")
        par = _train_parity(api, params, mb, floor, r"mamba/", counted,
                            wrappers, kernel, api.cfg.n_layers * 2)
        del params
        _free()
        ssm = api.cfg.ssm
        h = ssm.expand * api.cfg.d_model // ssm.head_dim
        par["function"] = _function_equal(
            kernel, (*mb["tokens"].shape, h, ssm.head_dim, ssm.n_groups,
                     ssm.state, ssm.chunk), gen)
        row["ssm_parity"] = par
        _train_band_check(arch, par, TRAIN_BANDS[arch], "mixer")
    finally:
        for kid in (cli, *examples.values()):
            if kid.poll() is None:
                kid.kill()
                kid.wait()
        tmp_dir.cleanup()
        _free()
    emit("train", **row, bands=TRAIN_BANDS, f32_rel_band=TRAIN_F32_REL,
         nvidia_smi=nvidia_smi())
    return row


#: the mirror phase: the campaign phase's stream cut to MIRROR_J jobs over
#: its K grid, faults off (the float64 mirror covers the deterministic
#: path), warm start; each run is (SimConfig fields, simulate_py keywords)
MIRROR_J = 300
MIRROR_RUNS = {
    "fcfs": (dict(mode="paper"), {}),
    "easy": (dict(mode="paper", queue="easy_backfill",
                  queue_window=EASY_WINDOW), {}),
    "event_easy": (dict(mode="paper", queue="easy_backfill",
                        queue_window=EASY_WINDOW, core="events"), {}),
    "conservative": (dict(mode="paper", queue="conservative",
                          queue_window=EASY_WINDOW),
                     {"check_reservations": True}),
    "capped": (dict(mode="paper", power_cap=52e3), {}),
    "dvfs": (dict(mode="dvfs_paper", core="events"), {}),
}
#: per-job fields and totals whose worst relative error is printed
MIRROR_REL = ("start", "finish", "wait", "energy", "runtime", "total_energy",
              "makespan", "total_wait", "max_wait", "peak_power",
              "idle_energy")


def _mirror_rel(card, ref, i, worst) -> None:
    """Fold lane ``i``'s relative error against the mirror's dict ``ref``
    into ``worst`` (field -> max)."""
    import numpy as np
    for f in MIRROR_REL:
        a = getattr(card, f)[i].double().cpu().numpy()
        b = np.asarray(ref[f], np.float64)
        if not np.isfinite(b).all():
            continue
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
        worst[f] = max(worst.get(f, 0.0), float(np.max(rel)))


def _mirror_stream():
    """The campaign stream's first MIRROR_J jobs."""
    from repro_torch.core import JSCC_SYSTEMS
    from repro_torch.data import make_stream_workload
    return _prefix(make_stream_workload(JSCC_SYSTEMS, CAMPAIGN_J, "poisson",
                                        rate=0.5, seed=0), MIRROR_J)


def _mirror_sched(fields):
    """(the run's warm ``SimConfig`` at the policy's K, a builder of its
    ``Scheduler`` over the K grid on a device: None is the card)."""
    import numpy as np
    from repro_torch.core import Scheduler, SimConfig
    cfg0 = SimConfig(warm_start=True, **fields)
    ks = np.array(CAMPAIGN_KS, np.float32)
    return cfg0, lambda dev=None: Scheduler(
        cfg0.policy().with_params(k=ks), warm_start=True,
        engine=fields.get("core") or None, device=dev)


def phase_mirror(counters: dict) -> dict:
    """The card's runs against the port's float64 mirror ``simulate_py``
    (computed on the host by ``cross_part``), at the reference's
    differential bands (``tests/test_differential_sim.py:34-46``): systems
    exact in every lane; energy, start, total energy and makespan within
    rtol 1e-5 (start atol 1e-3) in every lane whose backfill flags equal
    the mirror's.  A lane whose flags differ is a near-tie the f32 event
    clock breaks otherwise than the float64 mirror, as the reference's
    engine does against the reference's mirror on this stream (PERF.md):
    there the card's run must equal the port's CPU run on every field
    (sums within rtol 1e-6)."""
    import numpy as np
    import torch
    from repro_torch.kernels.kth_free import kth_free_cuda
    w = _mirror_stream()
    host = _cross_results()
    out = {}
    for name, (fields, _) in MIRROR_RUNS.items():
        _, sched = _mirror_sched(fields)
        kth_free_cuda.launches = 0
        t0 = time.perf_counter()
        card = sched().run(w)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        _count(counters, "kth_free", f"mirror_{name}",
               kth_free_cuda.launches)
        worst, departed = {}, []
        for i, k in enumerate(CAMPAIGN_KS):
            ref = {f: v.numpy() for f, v in host[f"mirror.{name}.{k}"]
                   .items()}
            check(np.array_equal(card.system[i].cpu().numpy(),
                                 ref["system"]),
                  f"mirror {name} K={k}: systems differ")
            if not np.array_equal(card.backfilled[i].cpu().numpy(),
                                  ref["backfilled"]):
                departed.append(float(k))
                continue
            np.testing.assert_allclose(card.energy[i].cpu().numpy(),
                                       ref["energy"], rtol=1e-5)
            np.testing.assert_allclose(card.start[i].cpu().numpy(),
                                       ref["start"], rtol=1e-5, atol=1e-3)
            for f in ("total_energy", "makespan"):
                np.testing.assert_allclose(float(getattr(card, f)[i]),
                                           float(ref[f]), rtol=1e-5)
            _mirror_rel(card, ref, i, worst)
        if departed:
            _same(_on_card(host[f"mirror.{name}.cpu"], card.makespan), card,
                  EVENT_FIELDS, ("total_energy", "total_wait",
                                 "slowdown_sum"), f"mirror {name} cpu/cuda")
        out[name] = dict(card_s=t_card,
                         kth_free_launches=counters["by_path"]["kth_free"]
                         [f"mirror_{name}"],
                         lanes_departed_k=departed,
                         cpu_equal_checked=bool(departed),
                         worst_rel_error=worst)
    emit("mirror", jobs=MIRROR_J, ks=list(CAMPAIGN_KS), runs=out)
    return out


#: the unrolled EASY loop: the ablation's contended SWF stream cut to
#: UNROLLED_J jobs, window 16, K x seeds with the campaign's faults
UNROLLED_J = 300
UNROLLED_KS = (0.0, 0.1, 0.2)
UNROLLED_SEEDS = (0, 1)
UNROLLED_TRACE_STEPS = 50
UNROLLED_FIELDS = ("system", "tier", "nodes", "start", "backfilled", "runs",
                   "n_backfilled")


def phase_easy_unrolled(counters: dict) -> dict:
    """``easy_eval="unrolled"`` (the reference's per-slot loop) against
    the batched step on the card: 2 W + 2 kth_free launches a step against
    2, placements and starts exact, the learned tables within the
    reference's own batched-against-unrolled band (C_tab 2.3e-10, T_tab
    7.6e-6); ms a step of both, and the unrolled step's device idle share
    over a 50-step trace of the device alone."""
    import numpy as np
    import torch
    from repro_torch.core.policy import apply_queue_spec, make_policy
    from repro_torch.kernels.kth_free import kth_free_cuda
    w = _prefix(_easy_stream(), UNROLLED_J)
    W = EASY_WINDOW
    steps = UNROLLED_J + W
    pol = apply_queue_spec(make_policy(
        "paper", k=np.array(UNROLLED_KS, np.float32)), EASY_QUEUE)
    kw = dict(policy=pol, seeds=UNROLLED_SEEDS)

    kth_free_cuda.launches = 0
    un, t_un, _ = _timed_campaign(w, easy_eval="unrolled", **kw)
    n_un = kth_free_cuda.launches
    _count(counters, "kth_free", "easy_unrolled", n_un)
    check(n_un == (2 * W + 2) * steps,
          f"unrolled kth_free launches {n_un} != (2 W + 2) (J + W) = "
          f"{(2 * W + 2) * steps}")
    bat, t_bat, n_bat = _timed_campaign(w, **kw)
    check(n_bat == 2 * steps, f"batched kth_free launches {n_bat}")
    for f in UNROLLED_FIELDS:
        check(torch.equal(getattr(un, f), getattr(bat, f)),
              f"unrolled != batched on {f}")
    check(bool((un.n_backfilled > 0).all()),
          f"a lane never backfilled: {un.n_backfilled.tolist()}")
    tables = {}
    for f, band in (("C_tab", 2.3e-10), ("T_tab", 7.6e-6)):
        d = float((getattr(un, f).double() - getattr(bat, f).double())
                  .abs().max())
        check(d <= band, f"unrolled {f} departs by {d} > {band}")
        tables[f] = d
    finish_ulps = float(((un.finish - bat.finish).abs()
                         / torch.finfo(torch.float32).eps
                         / bat.finish.abs()).max())

    # the idle share of a 50-step run: its wall time against the device
    # time of the same run traced alone (the profiler's cost not counted)
    small = _prefix(w, UNROLLED_TRACE_STEPS - W)
    _campaign(small, easy_eval="unrolled", **kw)
    _, t_small, _ = _timed_campaign(small, easy_eval="unrolled", **kw)
    per_step, busy_us, by_kernel = _launches_per_step(
        small, steps=UNROLLED_TRACE_STEPS, easy_eval="unrolled", **kw)
    step_us = t_small / UNROLLED_TRACE_STEPS * 1e6
    res = dict(
        jobs=UNROLLED_J, window=W, lanes=len(UNROLLED_KS) * len(UNROLLED_SEEDS),
        steps=steps, kth_free_launches=n_un,
        kth_free_launches_per_step=n_un / steps,
        batched_kth_free_launches_per_step=n_bat / steps,
        ms_per_step=t_un / steps * 1e3, batched_ms_per_step=t_bat / steps * 1e3,
        n_backfilled=un.n_backfilled.flatten().tolist(),
        tables_max_abs_diff=tables,
        finish_max_rel_diff_in_eps=finish_ulps,
        trace_steps=UNROLLED_TRACE_STEPS, trace_ms_per_step=step_us / 1e3,
        cuda_launches_per_step=per_step, device_busy_us_per_step=busy_us,
        device_us_per_step_by_kernel=by_kernel,
        device_idle_share=(None if busy_us is None
                           else 1.0 - busy_us / step_us))
    emit("easy_unrolled", **res)
    return res


def phase_roofline() -> dict:
    """Host only: the cost counter (``utils/cost.py``) on the 4 x 4,096
    bf16 prefills that ``serve`` and ``serve_ssm`` time, on one card (a
    1 x 1 mesh): FLOPs, HBM bytes and their bound at the H100's datasheet
    peaks (``launch/roofline.H100``), and the prefill wall time those
    phases measured as a share of that bound (null when they did not run
    in this process)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.launch.roofline import H100
    from repro_torch.launch.specs import build_all_specs
    from repro_torch.models import build_model
    from repro_torch.utils.cost import cell_cost
    shape = ShapeConfig("serve_prefill", seq_len=4096, global_batch=4,
                        kind="prefill")
    mesh = make_elastic_mesh(1, model_parallel=1, device="cpu")
    out = {}
    for phase, (arch, kernel, _) in SERVE_CELLS.items():
        t0 = time.perf_counter()
        api = build_model(get_config(arch), device="cpu")
        cost = cell_cost(api, shape, build_all_specs(api, shape, mesh,
                                                     multi_pod=False), mesh)
        count_s = time.perf_counter() - t0
        t_c = cost["flops_per_device"] / H100.flops
        t_m = cost["mem_bytes_per_device"] / H100.hbm_bw
        bound = max(t_c, t_m)
        wall = KEPT.get(f"{phase}_prefill_s")
        check(cost["flops_per_device"] > 0 and bound > 0,
              f"roofline {arch}: empty count")
        out[arch] = dict(
            shape=[4, 4096], dtype=api.cfg.dtype, kernel=kernel,
            flops=cost["flops_per_device"],
            attention_flops=cost["attn_flops_total"],
            hbm_bytes=cost["mem_bytes_per_device"],
            hbm_bytes_by_part=cost["mem_bytes_by_part"],
            t_compute_s=t_c, t_memory_s=t_m, bound_s=bound,
            bound_by="operations" if t_c >= t_m else "bytes",
            prefill_wall_s=wall,
            share_of_bound=None if wall is None else bound / wall,
            achieved_flops_per_s=(None if wall is None
                                  else cost["flops_per_device"] / wall),
            count_s=count_s)
    emit("roofline", peaks={"flops": H100.flops, "hbm_bw": H100.hbm_bw,
                            "source": "NVIDIA H100 SXM datasheet"},
         cells=out)
    return out


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
        "campaign_scale": lambda: phase_campaign_scale(counters),
        "cross_device": phase_cross_device,
        "schedule_cli": phase_schedule_cli,
        "service": lambda: phase_service(counters),
        "service_pool": lambda: phase_service_pool(counters),
        "workloads": lambda: phase_workloads(counters),
        "executed_campaign": phase_executed_campaign,
        "mirror": lambda: phase_mirror(counters),
        "easy_unrolled": lambda: phase_easy_unrolled(counters),
        "serve": lambda: phase_serve(counters, "serve"),
        "serve_ssm": lambda: phase_serve(counters, "serve_ssm"),
        "serve_moe": lambda: phase_serve_moe(counters),
        "serve_hybrid": lambda: phase_serve_hybrid(counters),
        "serve_encdec": lambda: phase_serve_encdec(counters),
        "serve_vlm": lambda: phase_serve_vlm(counters),
        "train": lambda: phase_train(counters),
        "roofline": phase_roofline,
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
    try:
        if only is None or {"cross_device", "mirror"} & set(only):
            _service_start(("cross_device",))   # the host's twins, early
        for name, fn in _phases(counters).items():
            if only is None or name in only:
                groups = [p for p in KID_GROUPS
                          if only is None or p in only]
                if name in ("campaign_scale", "cross_device",
                            "schedule_cli") and groups:
                    # the children run on the card beside these phases,
                    # which time nothing the later phases compare
                    _service_start(groups)
                if name == "event_campaign" and (
                        only is None or "campaign_scale" in only):
                    _scale_start()      # the million-job run, beside it
                t0 = time.perf_counter()
                results[name] = fn()
                phase_s[name] = time.perf_counter() - t0
        _event_finish()          # if no phase after event_campaign did
    finally:
        _service_stop()
        _scale_stop()
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
    #: the slices' other path shapes of a kernel, in its row
    shapes = {"flash_attention": "hd96", "ssd_scan": "jamba"}
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
        if name in shapes:
            kernels[-1][shapes[name]] = {
                key: k[shapes[name]].get(key) for key in (
                    "shape", "route", "kernel_us", "kernel_device_us",
                    "bound_ms", "bound_by", "plain_us", "library_us",
                    "issued_floor_ms", "max_abs_err", "y_max_abs_err")}
    emit("done", seconds=time.perf_counter() - t_start, phase_seconds=phase_s,
         campaign_ms_per_step=results["campaign"]["ms_per_step"],
         easy_ms_per_step=results["easy_campaign"]["ms_per_step"],
         event_ms_per_step={run: v["ms_per_step"] for run, v
                            in results["event_campaign"].items()
                            if "ms_per_step" in v},
         scale_ms_per_step={str(J): results["campaign_scale"]["scale"]
                            [str(J)]["ms_per_step"] for J in SCALE_JS},
         service_decision_latency_us=results["service"][
             "decision_latency_us"],
         service_pool_wall_us_per_step={
             n: v["wall_us_per_step"] for n, v
             in results["service_pool"]["by_n"].items()},
         train_ms_per_step={cell: results["train"][cell]["ms_per_step"]
                            for cell in (*TRAIN_CELLS, "data_parallel")},
         easy_unrolled_ms_per_step=results["easy_unrolled"]["ms_per_step"],
         prefill_share_of_bound={arch: v["share_of_bound"] for arch, v
                                 in results["roofline"].items()})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
