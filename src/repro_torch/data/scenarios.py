"""Scenario library: job-stream generators for scheduler campaigns.

Arrival processes (all return [n] f32 submit times, sorted):
  poisson_arrivals   — homogeneous rate
  diurnal_arrivals   — inhomogeneous sinusoidal day/night rate (thinning)
  bursty_arrivals    — Poisson bursts of correlated submissions

Job mixes: ``sample_programs`` draws program names from weighted size
classes (BT/EP run on few nodes, IS/LU/SP on many, per the paper's
Table 6).  Maintenance: ``maintenance_windows`` builds the [S, W, 2]
outage tensor.  ``make_stream_workload`` combines them into the port's
``Workload``.

Trace replay: ``load_swf`` parses the Standard Workload Format
(whitespace-separated fields, ';' comments, gzipped files ok) and
``workload_from_arrays`` / ``workload_from_trace`` map (submit, runtime,
procs) onto the multi-system ``Workload`` by binning jobs into program
classes and extrapolating each class across systems, with the relative
node-throughput model or (``calibrate=True`` / ``workload_from_swf``) the
phase model of ``core/workload_model.py``.  ``synthetic_swf_arrays``
generates contended SWF-shaped streams at any scale; ``swf_lines``
writes columns as SWF records.

Everything here is host numpy, seeded with ``np.random.default_rng``, so
a stream is the same on every device.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass

import numpy as np

from repro_torch.core.engine import Workload, make_npb_workload
from repro_torch.core.workload_model import (JobProfile, predict_energy,
                                             predict_phases)

NPB_SMALL = ("BT", "EP")          # 144-core class (2-5 nodes per system)
NPB_LARGE = ("IS", "LU", "SP")    # 256-core class (4-8 nodes per system)


# ------------------------------------------------------------------ arrivals

def poisson_arrivals(n: int, rate: float, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    """Homogeneous Poisson process: n submit times at ``rate`` jobs/sec."""
    rng = np.random.default_rng(seed)
    return (start + np.cumsum(rng.exponential(1.0 / rate, n))).astype(np.float32)


def diurnal_arrivals(n: int, base_rate: float, peak_rate: float,
                     period: float = 86_400.0, seed: int = 0) -> np.ndarray:
    """Inhomogeneous Poisson with sinusoidal rate in [base, peak] (day/night
    load), sampled by thinning against the peak rate."""
    if not peak_rate >= base_rate > 0:
        raise ValueError(f"need peak_rate >= base_rate > 0, got "
                         f"{peak_rate}, {base_rate}")
    rng = np.random.default_rng(seed)
    out = np.empty(n, np.float64)
    t, i = 0.0, 0
    while i < n:
        t += rng.exponential(1.0 / peak_rate)
        lam = base_rate + 0.5 * (peak_rate - base_rate) * (
            1.0 + np.sin(2.0 * np.pi * t / period))
        if rng.uniform() * peak_rate <= lam:
            out[i] = t
            i += 1
    return out.astype(np.float32)


def bursty_arrivals(n: int, burst_rate: float, burst_size_mean: float = 8.0,
                    burst_spread: float = 5.0, seed: int = 0) -> np.ndarray:
    """Bursts arrive as a Poisson process at ``burst_rate`` bursts/sec; each
    burst submits a geometric number of jobs within ``burst_spread`` seconds
    (array jobs / parameter-sweep campaigns)."""
    rng = np.random.default_rng(seed)
    times = []
    t = 0.0
    while len(times) < n:
        t += rng.exponential(1.0 / burst_rate)
        size = rng.geometric(1.0 / burst_size_mean)
        times.extend(t + rng.uniform(0.0, burst_spread, size))
    return np.sort(np.asarray(times[:n], np.float32))


ARRIVAL_KINDS = ("simultaneous", "poisson", "diurnal", "bursty")


def make_arrivals(kind: str, n: int, rate: float, seed: int = 0) -> np.ndarray | None:
    """Uniform entry point for the CLI/benchmarks; None = all at t=0."""
    if kind == "simultaneous" or rate <= 0:
        return None
    if kind == "poisson":
        return poisson_arrivals(n, rate, seed)
    if kind == "diurnal":
        return diurnal_arrivals(n, base_rate=rate * 0.2, peak_rate=rate * 1.8,
                                seed=seed)
    if kind == "bursty":
        return bursty_arrivals(n, burst_rate=rate / 8.0, seed=seed)
    raise ValueError(f"unknown arrival kind {kind!r}; known: {ARRIVAL_KINDS}")


# ------------------------------------------------------------------ job mix

def sample_programs(n: int, mix: dict | None = None, seed: int = 0) -> tuple:
    """Draw n program names from weighted size classes.

    ``mix`` maps a class (tuple of program names) or a single name to a
    weight; default: small and large NPB classes equally weighted."""
    rng = np.random.default_rng(seed)
    mix = mix or {NPB_SMALL: 0.5, NPB_LARGE: 0.5}
    classes = [(c,) if isinstance(c, str) else tuple(c) for c in mix]
    w = np.asarray([mix[c] for c in mix], np.float64)
    w = w / w.sum()
    picks = rng.choice(len(classes), size=n, p=w)
    return tuple(str(rng.choice(classes[c])) for c in picks)


# -------------------------------------------------------------- maintenance

def maintenance_windows(n_systems: int, windows: dict) -> np.ndarray:
    """Build the simulator's [S, W, 2] outage tensor.

    ``windows`` maps system index -> list of (start, end).  Pads with empty
    (0, 0) windows so every system has the same count; sorts per system.
    """
    W = max((len(v) for v in windows.values()), default=0)
    out = np.zeros((n_systems, W, 2), np.float32)
    for s, spans in windows.items():
        for i, (a, b) in enumerate(sorted(spans)):
            if b < a:
                raise ValueError(f"window ({a}, {b}) of system {s} ends "
                                 "before it starts")
            out[s, i] = (a, b)
    return out


# -------------------------------------------------------------- NPB streams

def make_stream_workload(systems, n_jobs: int, arrival: str = "poisson",
                         rate: float = 0.1, mix: dict | None = None,
                         seed: int = 0, pred_noise: float = 0.0,
                         outage: np.ndarray | None = None,
                         k_job: np.ndarray | None = None) -> Workload:
    """Campaign-scale NPB job stream: weighted job-size mix + an arrival
    process + optional maintenance windows, as one Workload."""
    order = sample_programs(n_jobs, mix, seed)
    arrivals = make_arrivals(arrival, n_jobs, rate, seed)
    return make_npb_workload(systems, order=order, arrivals=arrivals,
                             k_job=k_job, pred_noise=pred_noise,
                             noise_seed=seed, outage=outage)


# ------------------------------------------------------------- trace replay

@dataclass(frozen=True)
class TraceJob:
    """One SWF record (the fields the scheduler consumes)."""
    job_id: int
    submit: float       # seconds since log start
    runtime: float      # wall-clock seconds
    procs: int          # allocated (or requested) processors


def load_swf(source) -> list:
    """Parse SWF text into TraceJob records.

    ``source``: path (``.gz`` transparently gunzipped — the Feitelson
    archive ships gzipped logs), or iterable of lines.  SWF: 18
    whitespace-separated numeric fields per job; ';' starts a comment.
    Field 2 is submit time, 4 is runtime, 5 allocated processors (field 8,
    requested, is the fallback when allocation is missing).  Jobs with
    unknown runtime or zero processors are dropped; submit times are
    rebased to the first job.
    """
    if isinstance(source, (str, bytes, os.PathLike)):
        path = os.fsdecode(source)
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            lines = f.readlines()
    else:
        lines = list(source)
    jobs = []
    for line in lines:
        line = line.strip()
        if not line or line.startswith(";"):
            continue
        f = line.split()
        if len(f) < 8:
            continue
        runtime = float(f[3])
        procs = int(float(f[4]))
        if procs <= 0:
            procs = int(float(f[7]))
        if runtime <= 0 or procs <= 0:
            continue
        jobs.append(TraceJob(job_id=int(float(f[0])), submit=float(f[1]),
                             runtime=runtime, procs=procs))
    jobs.sort(key=lambda j: j.submit)
    if jobs:
        t0 = jobs[0].submit
        jobs = [TraceJob(j.job_id, j.submit - t0, j.runtime, j.procs)
                for j in jobs]
    return jobs


#: default (compute, net, disk) runtime shares assumed when calibrating a
#: trace job's phase behaviour (SWF logs carry no phase decomposition)
SWF_PHASE_FRACTIONS = (0.7, 0.2, 0.1)


def workload_from_arrays(submit, runtime, procs, systems,
                         n_size_bins: int = 4, n_time_bins: int = 4,
                         active_w: float = 250.0, calibrate: bool = False,
                         phase_fractions=SWF_PHASE_FRACTIONS) -> Workload:
    """Map raw (submit, runtime, procs) trace columns onto the
    multi-system simulator — the vectorized core of the SWF replay path
    (million-job traces never materialize per-job python objects).

    Jobs are binned into program classes by (procs, runtime) quantiles —
    the trace's analogue of "program p" whose (C, T) the scheduler learns.
    Each class's reference runtime is its median; per-system ground truth
    extrapolates by relative node throughput (peak_flops x efficiency),
    with node counts from ceil(procs / cores_per_node) and a first-order
    energy model E = n_nodes x (idle_w + active_w-ish) x T.  Coarse by
    construction — the scheduler only ever consumes relative (C, T).

    ``calibrate=True`` replaces the first-order energy model with the
    paper's phase model: each class's observed median runtime is split
    into (compute, net, disk) shares per ``phase_fractions``, a
    ``JobProfile`` is inverted from those shares on the reference system,
    and per-system (T, E) plus the DVFS phase split (``T_comp``/
    ``E_comp``) come from ``workload_model.predict_phases`` /
    ``predict_energy`` — so replayed jobs scale across systems with the
    same net/disk behaviour the NPB workloads carry, instead of pure
    flops throughput."""
    submit = np.asarray(submit, np.float64)
    runt = np.asarray(runtime, np.float64)
    procs = np.asarray(procs, np.float64)
    if not submit.size:
        raise ValueError("empty trace")
    S = len(systems)

    def _bin(x, nb):
        qs = np.quantile(x, np.linspace(0, 1, nb + 1)[1:-1])
        return np.searchsorted(qs, x, side="right")

    cls = _bin(procs, n_size_bins) * n_time_bins + _bin(runt, n_time_bins)
    uniq, prog = np.unique(cls, return_inverse=True)
    P = len(uniq)

    theta = np.asarray([s.peak_flops_node * s.efficiency for s in systems])
    cores = np.asarray([s.cores_per_node for s in systems], np.float64)
    nn = np.asarray([s.n_nodes for s in systems], np.float64)
    ref = int(np.argmax(theta * cores))   # most capable node type anchors T

    p_med = np.empty(P)
    t_med = np.empty(P)
    for pi in range(P):                   # <= n_size_bins * n_time_bins
        m = prog == pi
        p_med[pi] = np.median(procs[m])
        t_med[pi] = np.median(runt[m])

    n_req = np.minimum(np.maximum(np.ceil(p_med[:, None] / cores[None, :]),
                                  1.0), nn[None, :])             # [P, S]
    T_comp = E_comp = None
    if calibrate:
        T_true, E_true, C_true, T_comp, E_comp = _calibrated_tables(
            uniq, p_med, t_med, n_req, systems, ref, phase_fractions)
    else:
        flops_est = t_med * theta[ref] * np.maximum(
            np.ceil(p_med / cores[ref]), 1.0)
        T_true = flops_est[:, None] / (theta[None, :] * n_req)
        watts = np.asarray([s.idle_w + active_w for s in systems])
        E_true = n_req * watts[None, :] * T_true
        mops = np.maximum(T_true[:, [ref]] * theta[ref] * n_req[:, [ref]],
                          1.0) / 1e6
        C_true = E_true / mops

    J = len(submit)
    return Workload(
        prog=prog.astype(np.int32),
        arrival=submit.astype(np.float32),
        k_job=np.full(J, np.nan, np.float32),
        n_req=n_req.astype(np.int32),
        T_true=T_true, C_true=C_true, E_true=E_true,
        T_pred=T_true.copy(), C_pred=C_true.copy(),
        n_nodes=np.asarray([s.n_nodes for s in systems], np.int32),
        programs=tuple(f"class{int(u)}" for u in uniq),
        systems=tuple(s.name for s in systems),
        idle_w=np.asarray([s.idle_w for s in systems], np.float32),
        T_comp=T_comp, E_comp=E_comp,
    )


def _calibrated_tables(uniq, p_med, t_med, n_req, systems, ref,
                       phase_fractions):
    """Per-class phase-model tables: invert a ``JobProfile`` from the
    observed median runtime on the reference system (each phase is linear
    in its volume, so a unit-volume probe gives the exact scale), then
    predict every system from that one profile."""
    fc, fn, fd = (float(f) for f in phase_fractions)
    if abs(fc + fn + fd - 1.0) >= 1e-6:
        raise ValueError(f"phase fractions must sum to 1, got "
                         f"{phase_fractions}")
    P, S = n_req.shape
    T_true = np.zeros((P, S))
    E_true = np.zeros((P, S))
    C_true = np.zeros((P, S))
    T_comp = np.zeros((P, S))
    E_comp = np.zeros((P, S))
    for pi in range(P):
        name = f"class{int(uniq[pi])}"
        nr = int(n_req[pi, ref])
        probe = JobProfile(name, flops=1.0, net_bytes=1.0, disk_bytes=1.0)
        tc1, tn1, td1 = predict_phases(probe, systems[ref], nr)
        prof = JobProfile(name,
                          flops=fc * t_med[pi] / tc1,
                          net_bytes=fn * t_med[pi] / tn1,
                          disk_bytes=fd * t_med[pi] / td1)
        for s, sysm in enumerate(systems):
            n = int(n_req[pi, s])
            tc, _, _ = predict_phases(prof, sysm, n)
            E, _, T = predict_energy(prof, sysm, n)
            T_true[pi, s] = T
            E_true[pi, s] = E
            C_true[pi, s] = E / (prof.flops / 1e6)
            T_comp[pi, s] = tc
            E_comp[pi, s] = n * sysm.cpu_w * tc   # dynamic compute joules
    return T_true, E_true, C_true, T_comp, E_comp


def workload_from_trace(jobs, systems, n_size_bins: int = 4,
                        n_time_bins: int = 4, active_w: float = 250.0,
                        calibrate: bool = False,
                        phase_fractions=SWF_PHASE_FRACTIONS) -> Workload:
    """``TraceJob`` records -> Workload (see ``workload_from_arrays`` —
    this wrapper just extracts the columns)."""
    jobs = list(jobs)
    if not jobs:
        raise ValueError("empty trace")
    return workload_from_arrays(
        np.asarray([j.submit for j in jobs], np.float64),
        np.asarray([j.runtime for j in jobs], np.float64),
        np.asarray([j.procs for j in jobs], np.float64),
        systems, n_size_bins=n_size_bins, n_time_bins=n_time_bins,
        active_w=active_w, calibrate=calibrate,
        phase_fractions=phase_fractions)


def workload_from_swf(source, systems, *, calibrate: bool = True,
                      **kw) -> Workload:
    """One-call SWF replay: parse (gzipped ok) + build the Workload.
    Calibrates against the phase model by default — the archive path is
    for studies, not for the legacy first-order pin."""
    return workload_from_trace(load_swf(source), systems,
                               calibrate=calibrate, **kw)


# ------------------------------------------------- synthetic SWF campaigns

def synthetic_swf_arrays(n: int, seed: int = 11, mean_gap: float = 15.0):
    """A contended SWF-shaped column set at arbitrary scale: heavy-tailed
    runtimes and node counts with clustered submits (long wide head jobs
    blocking short narrow ones — the shape backfilling was made for).
    Returns (submit, runtime, procs) integer arrays, ready for
    ``workload_from_arrays`` or ``swf_lines``."""
    rng = np.random.default_rng(seed)
    submit = np.cumsum(rng.exponential(mean_gap, n)).astype(np.int64)
    runtime = np.where(rng.random(n) < 0.25,
                       rng.integers(1500, 5000, n),      # long tail
                       rng.integers(60, 400, n))         # short majority
    procs = np.where(rng.random(n) < 0.3,
                     rng.integers(96, 257, n),           # wide
                     rng.integers(4, 33, n))             # narrow
    return submit, runtime, procs


def swf_lines(submit, runtime, procs):
    """Serialize trace columns as SWF records (18 fields, the subset the
    loader consumes populated) — fixture generation and loader
    round-trip tests."""
    return [f"{i + 1} {int(s)} 0 {int(r)} {int(p)} 100.0 0 {int(p)} "
            "0 0 1 1 1 1 1 1 -1 -1"
            for i, (s, r, p) in enumerate(zip(submit, runtime, procs))]
