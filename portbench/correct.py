"""How ``correct`` is decided: a sample of the window's lanes, drawn from
the seed, against the plain reference run on the same inputs.

Every campaign of the window gets ``lanes_per_campaign`` lanes drawn from
the seed (the first campaign also its first and last lane); when more
than ``campaigns`` campaigns ran, a seed-drawn subset of them is compared.
The reference builds its own tables from the stream's raw columns and
runs every sampled lane.  Three numbers, each with its limit from the
cell's file:

  placements_diff  per sampled lane, the (program, system) placement
                   counts and the backfill count that differ from the
                   reference's, summed (a decision taken otherwise)
  totals_rel_gap   the widest relative gap of a float total or learned
                   table entry of a sampled lane from the reference's
  lanes_bad        lanes of every campaign (not only the sampled ones)
                   that did not place every job once or whose energy is
                   not a positive finite number
"""

from __future__ import annotations

import numpy as np

from portbench.reference import model, sched

FLOAT_FIELDS = ("total_energy", "total_wait", "slowdown_sum", "makespan",
                "max_wait", "busy", "idle_energy", "C_tab", "T_tab")
EXACT_FIELDS = ("runs", "n_backfilled")
NUMBERS = ("placements_diff", "totals_rel_gap", "lanes_bad")


def sample_lanes(seed: int, campaign: int, lanes: int, m: int) -> np.ndarray:
    """The ``m`` lanes (sorted) of window campaign ``campaign`` (1, 2, ...)
    that may be compared; the first campaign's include its first and last
    lane."""
    rng = np.random.default_rng([seed, campaign])
    if campaign != 1:
        return np.sort(rng.choice(lanes, size=m, replace=False))
    inner = rng.choice(np.arange(1, lanes - 1), size=m - 2, replace=False)
    return np.sort(np.concatenate([[0, lanes - 1], inner]))


def campaigns_compared(seed: int, n: int, cap: int) -> list:
    """Which of the window's ``n`` campaigns (1..n) are compared."""
    if n <= cap:
        return list(range(1, n + 1))
    rng = np.random.default_rng([seed, 0])
    return sorted(int(c) + 1 for c in rng.choice(n, size=cap, replace=False))


def reference_tables(traffic: dict, config: dict, jobs: int) -> dict:
    """The reference's own tables of the stream's first ``jobs`` jobs."""
    names = config["systems"]
    if traffic["kind"] == "npb_stream":
        tab = model.npb_tables(names, traffic["order"], traffic["arrival"])
    else:
        tab = model.swf_tables(names, *model.parse_swf(traffic["lines"]))
    return model.prefix(tab, jobs)


def lane_inputs(config: dict, seeds_of_lane) -> dict:
    """The reference's lane parameters for lanes given as (K index, lane
    seed) pairs."""
    k_grid = np.asarray(config["k_grid"], np.float32)
    f = config["faults"]
    fvec = np.array([f.get("straggler_prob", 0.0),
                     f.get("straggler_factor", 2.0),
                     f.get("failure_prob", 0.0),
                     f.get("restart_overhead", 0.5)], np.float32)
    g = np.array([g for g, _ in seeds_of_lane], np.int64)
    return {"k": k_grid[g],
            "seed": np.array([s for _, s in seeds_of_lane], np.int64),
            "fvec": np.tile(fvec, (len(g), 1))}


def reference_run(tab: dict, config: dict, lanes: dict,
                  prec: str = "f32") -> dict:
    queue, _, opt = config["queue"].partition(":")
    if queue == "fcfs":
        return sched.run_fcfs(tab, lanes, prec)
    if queue == "easy_backfill":
        window = int(opt.partition("=")[2]) if opt else 8
        return sched.run_easy(tab, lanes, window, prec)
    raise ValueError(f"the reference has no queue {config['queue']!r}")


def compare(got: dict, want: dict) -> dict:
    """placements_diff and totals_rel_gap of sampled lanes ``got`` (the
    program's fields, [L, ...] numpy) against the reference's ``want``."""
    diff = sum(int((np.asarray(got[f]) != np.asarray(want[f])).sum())
               for f in EXACT_FIELDS)
    gap = 0.0
    tiny = np.finfo(np.float32).tiny
    for f in FLOAT_FIELDS:
        a = np.asarray(got[f], np.float64)
        b = np.asarray(want[f], np.float64)
        rel = np.abs(a - b) / np.maximum(np.abs(b), tiny)
        rel = np.where(a == b, 0.0, rel)              # equal infinities
        gap = max(gap, float(np.nan_to_num(rel, nan=np.inf).max()))
    return {"placements_diff": diff, "totals_rel_gap": gap}


def wrong_lanes(got: dict, want: dict, gap_limit: float) -> int:
    """Sampled lanes with a decision taken otherwise or a total off by
    more than ``gap_limit``."""
    n = len(np.asarray(want["n_backfilled"]))
    wrong = np.zeros(n, bool)
    for f in EXACT_FIELDS + FLOAT_FIELDS:
        a = np.asarray(got[f]).reshape(n, -1).astype(np.float64)
        b = np.asarray(want[f]).reshape(n, -1).astype(np.float64)
        if f in EXACT_FIELDS:
            wrong |= (a != b).any(1)
        else:
            rel = np.abs(a - b) / np.maximum(np.abs(b),
                                             np.finfo(np.float32).tiny)
            wrong |= ((a != b) & ~(rel <= gap_limit)).any(1)
    return int(wrong.sum())


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in NUMBERS)
