"""Scenario library: job-stream generators for scheduler campaigns.

Arrival processes (all return [n] f32 submit times, sorted):
  poisson_arrivals   — homogeneous rate
  diurnal_arrivals   — inhomogeneous sinusoidal day/night rate (thinning)
  bursty_arrivals    — Poisson bursts of correlated submissions

Job mixes: ``sample_programs`` draws program names from weighted size
classes (BT/EP run on few nodes, IS/LU/SP on many, per the paper's
Table 6).  Maintenance: ``maintenance_windows`` builds the [S, W, 2]
outage tensor.  ``make_stream_workload`` combines them into the port's
``Workload``.  Everything here is numpy, seeded with
``np.random.default_rng``, so a stream is the same on every device.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.engine import Workload, make_npb_workload

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
