"""The one traffic generator: a mix's parameter file
(``portbench/traffic/<mix>.json``) and a seed in, the stream's raw columns
out.  Both sides get the same columns: the program through its own front
end, the reference through its own tables.

Kinds:

  ``npb_stream``     NPB program names drawn from weighted size classes,
                     with Poisson arrivals: ``{"order", "arrival"}``
  ``swf_synthetic``  a contended SWF log (heavy-tailed runtimes, wide and
                     narrow jobs, clustered submits) as SWF text lines:
                     ``{"lines"}``

The draws are the scenario library's, in its order, so that a mix with
the documented parameters gives the documented stream.
"""

from __future__ import annotations

import numpy as np

KINDS = ("npb_stream", "swf_synthetic")


def stream_seed(seed: int) -> int:
    """A run's ``--seed`` as a numpy seed (any whole number)."""
    return int(seed) % (2 ** 63)


def _programs(n: int, mix, seed: int) -> tuple:
    """n program names: a class drawn by weight, then a program of it."""
    rng = np.random.default_rng(seed)
    classes = [tuple(c) for c, _ in mix]
    w = np.asarray([weight for _, weight in mix], np.float64)
    picks = rng.choice(len(classes), size=n, p=w / w.sum())
    return tuple(str(rng.choice(classes[c])) for c in picks)


def _poisson(n: int, rate: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, n)).astype(np.float32)


def _swf_columns(n: int, seed: int, p: dict):
    rng = np.random.default_rng(seed)
    submit = np.cumsum(rng.exponential(p["mean_gap"], n)).astype(np.int64)
    runtime = np.where(rng.random(n) < p["long_share"],
                       rng.integers(*p["long_runtime"], n),
                       rng.integers(*p["short_runtime"], n))
    procs = np.where(rng.random(n) < p["wide_share"],
                     rng.integers(*p["wide_procs"], n),
                     rng.integers(*p["narrow_procs"], n))
    return submit, runtime, procs


def swf_lines(submit, runtime, procs) -> list:
    """Trace columns as SWF records (18 fields; job id, submit, wait 0,
    runtime, allocated processors, CPU time, memory, requested
    processors, the rest unknown)."""
    return [f"{i + 1} {int(s)} 0 {int(r)} {int(p)} 100.0 0 {int(p)} "
            "0 0 1 1 1 1 1 1 -1 -1"
            for i, (s, r, p) in enumerate(zip(submit, runtime, procs))]


def generate(mix: dict, seed: int) -> dict:
    """The raw stream of ``mix`` for run seed ``seed``."""
    kind, n, s = mix["kind"], int(mix["jobs"]), stream_seed(seed)
    if kind == "npb_stream":
        if mix["arrival"] != "poisson":
            raise ValueError(f"unknown arrival process {mix['arrival']!r}")
        return {"kind": kind, "order": _programs(n, mix["mix"], s),
                "arrival": _poisson(n, float(mix["rate"]), s)}
    if kind == "swf_synthetic":
        return {"kind": kind, "lines": swf_lines(*_swf_columns(n, s, mix))}
    raise ValueError(f"unknown traffic kind {kind!r}; known: {KINDS}")
