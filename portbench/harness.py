"""One run of one cell: set-up, the measured window, the traced campaign,
the readers, and the comparison with the reference.

The window runs whole campaigns back to back through the port's
``Scheduler.run``, each over the next R lane seeds of the run's block, so
no two repeat; the campaign still running at ``seconds`` is finished and
counted, and the window ends when the device has finished it.  With
``trace`` the run then profiles one campaign of the stream's first
``trace_jobs`` jobs at the cell's lanes (device operations only) and
counts the host synchronisations of another.  The reference runs last,
on the host, once the program's state is freed.

Each metric's reader gets the run's ``ctx``: the cell (``cell``,
``config``, ``own``: its own file), the shapes (``lanes``, ``systems``,
``nodes``, ``jobs``, ``window``: EASY's pending window, 0 for FCFS), the
window (``campaigns``, ``campaign_ends``: host seconds at which each was
enqueued, ``wall_s``, ``setup_s``, ``lane_jobs``, ``window_steps``,
``kth_launches``, ``n_backfilled``, ``peak_bytes``: None off the card) and
the traced campaign (``trace``: a ``measure.Trace`` or None,
``trace_steps``, ``trace_kth_launches``, ``syncs``).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench import correct, generator, measure, spec

#: modules the process must not hold, by top-level name
BANNED = ("jax", "jaxlib", "flax", "repro")
#: campaigns a window may hold (their compared lanes are drawn at set-up)
MAX_CAMPAIGNS = 1024


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def seed_base(seed: int) -> int:
    """The first lane seed of a run: lane seeds stay below 2**31."""
    return int(np.random.default_rng([generator.stream_seed(seed), 1])
               .integers(0, 2 ** 30))


def steps_per_campaign(config: dict, jobs: int) -> int:
    """Steps of one campaign of the arrival-indexed cores: one a job for
    FCFS, and the window's drain steps besides for EASY."""
    queue, _, opt = config["queue"].partition(":")
    if queue == "fcfs":
        return jobs
    if queue == "easy_backfill":
        return jobs + (int(opt.partition("=")[2]) if opt else 8)
    raise ValueError(f"no step count for queue {config['queue']!r}")


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
             device: str, t_process: float, overrides: dict | None = None,
             log=print) -> dict:
    """Run ``cell`` and return its result line (a dict).  ``overrides``
    (tests only) replaces entries of the cell's own file and the
    configuration's ``jobs_per_campaign``."""
    import torch

    from portbench import program
    own = {**cell.own, **(overrides or {})}
    config = cell.config
    jobs = int(own.get("jobs_per_campaign", config["jobs_per_campaign"]))
    R = int(own["seeds_per_campaign"])
    G = len(config["k_grid"])
    B = G * R
    base = seed_base(seed)
    block = lambda c: range(base + c * R, base + (c + 1) * R)  # noqa: E731
    on_card = torch.device(device).type == "cuda"

    # set-up: the stream on the host through the port's front end, the
    # kernel library, one warm campaign of a few steps at the cell's lanes
    stream_seed = generator.stream_seed(seed)
    m = min(int(own["check"]["lanes_per_campaign"]), B)
    samples = np.stack([correct.sample_lanes(stream_seed, c, B, m)
                        for c in range(1, MAX_CAMPAIGNS + 1)])
    sample_idx = torch.as_tensor(samples, device=device)
    traffic = generator.generate(cell.traffic, seed)
    w_all = program.build_workload(traffic, config)
    w = program.prefix(w_all, jobs)
    P = int(np.shape(w.n_req)[0])
    S = len(config["systems"])
    if on_card:
        program.build_kernels()
    program.run(program.scheduler(config, block(0), device),
                program.prefix(w_all, int(own["warm_jobs"])), config)
    program.synchronize(device)
    setup_s = time.perf_counter() - t_process
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # the window
    kept, bad_lanes, n_bf, ends = {}, [], [], []
    k0 = program.kth_launches()
    t0 = time.perf_counter()
    c = 0
    while True:
        c += 1
        if c > MAX_CAMPAIGNS:
            raise RuntimeError(f"more than {MAX_CAMPAIGNS} campaigns in "
                               "one window")
        out = program.run(program.scheduler(config, block(c), device), w,
                          config)
        kept[c] = {f: out[f].index_select(0, sample_idx[c - 1])
                   for f in out}
        placed = out["runs"].sum((-2, -1))
        energy = out["total_energy"]
        bad_lanes.append(((placed != P * S + jobs) | ~torch.isfinite(energy)
                          | (energy <= 0)).sum())
        n_bf.append(out["n_backfilled"].sum())
        del out, placed, energy
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    program.synchronize(device)
    wall = time.perf_counter() - t0
    kth_window = program.kth_launches() - k0
    peak = torch.cuda.max_memory_allocated() if on_card else None
    n_camp = c
    steps = n_camp * steps_per_campaign(config, jobs)

    ctx = dict(cell=cell.name, config=config, own=own,
               queue=config["queue"].partition(":")[0],
               window=steps_per_campaign(config, jobs) - jobs, lanes=B,
               systems=S, nodes=int(np.max(w.n_nodes)), jobs=jobs,
               campaigns=n_camp, campaign_ends=ends, wall_s=wall,
               setup_s=setup_s,
               lane_jobs=n_camp * jobs * B, peak_bytes=peak,
               window_steps=steps, kth_launches=kth_window,
               n_backfilled=int(sum(int(x) for x in n_bf)),
               trace=None, trace_steps=None, trace_kth_launches=None,
               syncs=None)

    if trace and on_card:
        wt = program.prefix(w_all, int(own["trace_jobs"]))
        ctx["trace_steps"] = steps_per_campaign(config, len(wt.prog))
        k1 = program.kth_launches()
        ctx["trace"] = measure.device_trace(lambda: program.run(
            program.scheduler(config, block(n_camp + 1), device), wt,
            config))
        ctx["trace_kth_launches"] = program.kth_launches() - k1
        ctx["syncs"] = measure.sync_count(lambda: program.run(
            program.scheduler(config, block(n_camp + 2), device), wt,
            config))

    metrics = {}
    for m_entry in cell.metrics:
        value = spec.reader(m_entry["name"])(ctx)
        if value is not None:
            metrics[m_entry["name"]] = {"value": value,
                                        "unit": m_entry["unit"]}

    # the comparison, on the host, once the program's state is freed
    lanes_bad = int(sum(int(x) for x in bad_lanes))
    chosen = correct.campaigns_compared(stream_seed, n_camp,
                                        int(own["check"]["campaigns"]))
    got = {f: np.concatenate([kept[k][f].cpu().numpy() for k in chosen])
           for f in program.FIELDS}
    pairs = [(int(i) // R, block(k)[int(i) % R])
             for k in chosen for i in samples[k - 1]]
    del kept, sample_idx
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = correct.reference_run(
        correct.reference_tables(traffic, config, jobs), config,
        correct.lane_inputs(config, pairs))
    numbers = {**correct.compare(got, want), "lanes_bad": lanes_bad}
    ref_s = time.perf_counter() - t_ref
    limits = own["limits"]
    ok = correct.verdict(numbers, limits)
    wrong = correct.wrong_lanes(got, want, limits["totals_rel_gap"])

    log(f"cell {cell.name} seed {seed}: {n_camp} campaigns of {jobs} jobs x "
        f"{B} lanes in {wall:.3f} s, set-up {setup_s:.3f} s, "
        f"{len(pairs)} lanes compared in {ref_s:.3f} s; campaigns "
        f"enqueued by {', '.join(f'{e:.3f}' for e in ends)} s")
    for k in correct.NUMBERS:
        log(f"check {k} {numbers[k]!r} limit {limits[k]!r}")
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name() if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": peak or 0}
    line = {"correct": ok, "attempted": n_camp * B,
            "failed": lanes_bad + wrong, "metrics": metrics,
            "device": device_info}
    if ctx["trace"] is not None:
        tr = ctx["trace"]
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.wall_s
        line["breakdown"] = {
            "device_ops": measure.top(tr.seconds_by_name()),
            "idle_gaps": measure.top(tr.idle_gaps())}
    line["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                      for k in correct.NUMBERS}
    return line
