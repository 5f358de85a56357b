"""Every table a campaign reads, built from first principles on the host.

The four JSCC RAS systems of the paper's platform, the NPB class-D phase
model at the paper's Table 6 node counts, and the SWF loader with its
class binning: float64 numpy, frozen copies of the arithmetic that the
scheduler's front end documents (the same operations in the same order,
so the tables come out bit for bit).  Nothing here is read from the
program under test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: the node-free value of a node that does not exist (f32 1e30)
BIG = np.float32(1e30)


@dataclass(frozen=True)
class System:
    name: str
    n_nodes: int
    cores_per_node: int
    peak_flops_node: float
    mem_bw_node: float
    net_bw_node: float
    disk_bw_node: float
    idle_w: float
    cpu_w: float
    net_w: float
    disk_w: float
    efficiency: float
    scalar_eff: float = 0.55


SYSTEMS = {s.name: s for s in (
    System("KNL", 38, 72, 3.0e12, 400e9, 12.5e9, 2e9,
           120.0, 230.0, 18.0, 12.0, 0.16, 0.20),
    System("Broadwell", 136, 32, 1.33e12, 153e9, 12.5e9, 2e9,
           110.0, 290.0, 15.0, 12.0, 0.14, 0.60),
    System("Skylake", 58, 36, 3.46e12, 256e9, 12.5e9, 2e9,
           130.0, 420.0, 15.0, 12.0, 0.13, 0.50),
    System("CascadeLake", 51, 48, 4.6e12, 282e9, 12.5e9, 2e9,
           135.0, 430.0, 15.0, 12.0, 0.135, 0.50),
)}


@dataclass(frozen=True)
class Profile:
    flops: float
    net_bytes: float
    disk_bytes: float
    mem_bytes: float
    parallel_eff: float
    vector_friendly: float
    net_eff: float


_GRID_D = 408 ** 3
_EP_PAIRS = 2 ** 36
_IS_KEYS = 2 ** 31

#: NPB class D: operation and byte totals per program
NPB_PROFILES = {
    "BT": Profile(_GRID_D * 250 * 5000, 250 * 6 * (408 ** 2) * 5 * 8 * 12,
                  60e9, _GRID_D * 250 * 900, 0.85, 0.75, 0.5),
    "EP": Profile(_EP_PAIRS * 100, 1e6, 1e8, _EP_PAIRS * 16, 0.99, 0.9, 0.5),
    "IS": Profile(_IS_KEYS * 45, _IS_KEYS * 4 * 10 * 2.2, 2e9,
                  _IS_KEYS * 4 * 10 * 6, 0.80, 0.3, 0.15),
    "LU": Profile(_GRID_D * 300 * 2000, 300 * 6 * (408 ** 2) * 5 * 8 * 20,
                  40e9, _GRID_D * 300 * 600, 0.70, 0.55, 0.10),
    "SP": Profile(_GRID_D * 500 * 2800, 500 * 6 * (408 ** 2) * 5 * 8 * 12,
                  50e9, _GRID_D * 500 * 700, 0.82, 0.7, 0.4),
}

#: the paper's Table 6: compute nodes per system for each program
NPB_NODES = {
    "BT": {"Broadwell": 5, "CascadeLake": 3, "KNL": 2, "Skylake": 4},
    "EP": {"Broadwell": 5, "CascadeLake": 3, "KNL": 2, "Skylake": 4},
    "IS": {"Broadwell": 8, "CascadeLake": 6, "KNL": 4, "Skylake": 8},
    "LU": {"Broadwell": 8, "CascadeLake": 6, "KNL": 4, "Skylake": 8},
    "SP": {"Broadwell": 8, "CascadeLake": 6, "KNL": 4, "Skylake": 8},
}


def _phases(prof: Profile, s: System, n: int):
    """(compute, network, disk) seconds of ``prof`` on ``n`` nodes of
    ``s``, phases serialised."""
    eff = s.efficiency * prof.parallel_eff
    simd = prof.vector_friendly + (1.0 - prof.vector_friendly) * s.scalar_eff
    t_comp = prof.flops / (n * s.peak_flops_node * eff * simd)
    if prof.mem_bytes:
        t_comp = max(t_comp, prof.mem_bytes / (n * s.mem_bw_node))
    t_net = prof.net_bytes / (n * s.net_bw_node * prof.net_eff)
    t_disk = prof.disk_bytes / (n * s.disk_bw_node)
    return t_comp, t_net, t_disk


def _systems(names):
    return [SYSTEMS[n] for n in names]


def _free0(systems) -> np.ndarray:
    """[S, maxN] f32 node-free table at time 0: 0 for a node, BIG past a
    system's last node."""
    nn = np.array([s.n_nodes for s in systems])
    exist = np.arange(nn.max())[None, :] < nn[:, None]
    return np.where(exist, np.float32(0.0), BIG).astype(np.float32)


def _tables(systems, prog, arrival, T, C, E, N) -> dict:
    f32 = lambda x: np.asarray(x, np.float64).astype(np.float32)  # noqa: E731
    return dict(prog=np.asarray(prog, np.int64),
                arrival=np.asarray(arrival, np.float32),
                T=f32(T), C=f32(C), E=f32(E),
                n_req=np.asarray(N, np.int64),
                idle_w=np.array([s.idle_w for s in systems], np.float32),
                free0=_free0(systems))


def npb_tables(system_names, order, arrival) -> dict:
    """The NPB stream ``order`` (program names) with its ``arrival``
    times: per-program runtime T, energy coefficient C (J/Mop) and energy
    E = C x Mop on every system, at Table 6's node counts."""
    systems = _systems(system_names)
    programs = tuple(sorted(set(order)))
    P, S = len(programs), len(systems)
    C = np.zeros((P, S))
    T = np.zeros((P, S))
    N = np.zeros((P, S), np.int32)
    for i, name in enumerate(programs):
        prof = NPB_PROFILES[name]
        for j, s in enumerate(systems):
            n = NPB_NODES[name][s.name]
            tc, tn, td = _phases(prof, s, n)
            t = tc + tn + td
            e = n * (s.idle_w * t + s.cpu_w * tc + s.net_w * tn
                     + s.disk_w * td)
            N[i, j] = n
            C[i, j] = e / (prof.flops / 1e6)
            T[i, j] = float(sum((tc, tn, td)))
    mops = np.array([NPB_PROFILES[p].flops / 1e6 for p in programs])
    idx = {p: i for i, p in enumerate(programs)}
    return _tables(systems, [idx[p] for p in order], arrival, T, C,
                   C * mops[:, None], N)


def parse_swf(lines):
    """SWF records -> (submit, runtime, procs) float64 columns: 18 fields
    a line, ';' comments; field 2 submit, 4 runtime, 5 allocated
    processors (8, requested, when 5 is not positive); jobs without a
    runtime or processors dropped; stably sorted by submit and rebased to
    the first."""
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
        jobs.append((float(f[1]), runtime, procs))
    jobs.sort(key=lambda j: j[0])
    t0 = jobs[0][0]
    return (np.asarray([j[0] - t0 for j in jobs], np.float64),
            np.asarray([j[1] for j in jobs], np.float64),
            np.asarray([j[2] for j in jobs], np.float64))


def swf_tables(system_names, submit, runtime, procs, n_size_bins: int = 4,
               n_time_bins: int = 4, active_w: float = 250.0) -> dict:
    """Trace columns -> program classes by (procs, runtime) quantile bins;
    each class's median runtime carried to every system by relative node
    throughput, energy E = nodes x (idle + active watts) x T."""
    systems = _systems(system_names)
    submit = np.asarray(submit, np.float64)
    runt = np.asarray(runtime, np.float64)
    procs = np.asarray(procs, np.float64)

    def _bin(x, nb):
        qs = np.quantile(x, np.linspace(0, 1, nb + 1)[1:-1])
        return np.searchsorted(qs, x, side="right")

    cls = _bin(procs, n_size_bins) * n_time_bins + _bin(runt, n_time_bins)
    uniq, prog = np.unique(cls, return_inverse=True)
    P = len(uniq)
    theta = np.asarray([s.peak_flops_node * s.efficiency for s in systems])
    cores = np.asarray([s.cores_per_node for s in systems], np.float64)
    nn = np.asarray([s.n_nodes for s in systems], np.float64)
    ref = int(np.argmax(theta * cores))
    p_med = np.empty(P)
    t_med = np.empty(P)
    for pi in range(P):
        m = prog == pi
        p_med[pi] = np.median(procs[m])
        t_med[pi] = np.median(runt[m])
    n_req = np.minimum(np.maximum(np.ceil(p_med[:, None] / cores[None, :]),
                                  1.0), nn[None, :])
    flops = t_med * theta[ref] * np.maximum(np.ceil(p_med / cores[ref]), 1.0)
    T = flops[:, None] / (theta[None, :] * n_req)
    watts = np.asarray([s.idle_w + active_w for s in systems])
    E = n_req * watts[None, :] * T
    mops = np.maximum(T[:, [ref]] * theta[ref] * n_req[:, [ref]], 1.0) / 1e6
    return _tables(systems, prog, submit, T, E / mops, E,
                   n_req.astype(np.int32))


def prefix(tab: dict, n: int) -> dict:
    """The first ``n`` jobs of a stream's tables."""
    return {**tab, "prog": tab["prog"][:n], "arrival": tab["arrival"][:n]}
