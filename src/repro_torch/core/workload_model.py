"""Phase-based runtime & energy model for jobs on computing systems.

The paper ([10], §Problem) decomposes parallel execution into compute,
external-memory and communication phases; SUPPZ measures per-phase power.
We *model* those measurements: a job carries total op/byte counts per phase
and the model predicts (T, E, C) on any system.  These predictions drive
(a) the simulator's ground truth and (b) the beyond-paper "predictive
cold-start" scheduler.

Units note (DESIGN.md §11): the paper reports C in the 1e-3..7.5e-3 "J/op"
range, which is consistent with NPB's native performance unit, Mop/s.  We
therefore express P in Mop/s and C in J/Mop — magnitudes then reproduce the
paper's Table 5 directly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.systems import ComputeSystem


@dataclass(frozen=True)
class JobProfile:
    """Resource totals for one program run at its assigned scale."""
    name: str
    flops: float               # total computational operations
    net_bytes: float           # total communication volume (all nodes)
    disk_bytes: float          # total external-memory (I/O) volume
    mem_bytes: float = 0.0     # HBM/DRAM traffic (roofline memory term)
    parallel_eff: float = 0.9  # strong-scaling efficiency at the given CN count
    vector_friendly: float = 1.0   # how well the code uses wide SIMD (KNL/SKX skew)
    net_eff: float = 0.5       # achieved fraction of injection bw (pattern-dependent)


def predict_phases(prof: JobProfile, sys: ComputeSystem, n_nodes: int):
    """Return (t_comp, t_net, t_disk) in seconds (phases serialized, per the
    paper's phase model)."""
    eff = sys.efficiency * prof.parallel_eff
    # vector-unfriendly codes lose more on wide-SIMD machines (KNL):
    simd_factor = prof.vector_friendly + (1.0 - prof.vector_friendly) * sys.scalar_eff
    flops_rate = n_nodes * sys.peak_flops_node * eff * simd_factor
    t_comp = prof.flops / flops_rate
    # memory-bound correction: compute phase cannot beat the memory roofline
    if prof.mem_bytes:
        t_comp = max(t_comp, prof.mem_bytes / (n_nodes * sys.mem_bw_node))
    t_net = prof.net_bytes / (n_nodes * sys.net_bw_node * prof.net_eff)
    t_disk = prof.disk_bytes / (n_nodes * sys.disk_bw_node)
    return t_comp, t_net, t_disk


def predict_runtime(prof: JobProfile, sys: ComputeSystem, n_nodes: int) -> float:
    return float(sum(predict_phases(prof, sys, n_nodes)))


def predict_energy(prof: JobProfile, sys: ComputeSystem, n_nodes: int):
    """Paper eq. (1)+(2): E = sum_j int W^j(t) dt with W^j = idle + phase
    components.  Returns (E_joules, W_avg_watts, T_seconds)."""
    t_comp, t_net, t_disk = predict_phases(prof, sys, n_nodes)
    T = t_comp + t_net + t_disk
    E = n_nodes * (sys.idle_w * T + sys.cpu_w * t_comp
                   + sys.net_w * t_net + sys.disk_w * t_disk)
    W_avg = E / max(T, 1e-12)
    return E, W_avg, T


def energy_coefficient(prof: JobProfile, sys: ComputeSystem, n_nodes: int) -> float:
    """C = W / P with P in Mop/s  =>  C = E / (flops/1e6)   [J/Mop]."""
    E, _, _ = predict_energy(prof, sys, n_nodes)
    return E / (prof.flops / 1e6)


# --------------------------------------------------------------------------
# NPB class-D analytic profiles (documented approximations; DESIGN.md §11).
# Grid 408^3 for BT/SP/LU; EP 2^36 pairs; IS 2^31 keys, 10 ranking iters.
# flops/point/iteration from the NPB reports' operation counts.
# --------------------------------------------------------------------------

_GRID_D = 408 ** 3                # 6.79e7 points
_EP_PAIRS = 2 ** 36
_IS_KEYS = 2 ** 31

NPB_PROFILES = {
    # BT: ADI block-tridiagonal; compute-heavy, moderate nearest-neighbour comm
    "BT": JobProfile("BT", flops=_GRID_D * 250 * 5000,
                     net_bytes=250 * 6 * (408 ** 2) * 5 * 8 * 12,
                     disk_bytes=60e9, mem_bytes=_GRID_D * 250 * 900,
                     parallel_eff=0.85, vector_friendly=0.75, net_eff=0.5),
    # EP: embarrassingly parallel RNG (log/sqrt per pair); zero comm
    "EP": JobProfile("EP", flops=_EP_PAIRS * 100,
                     net_bytes=1e6, disk_bytes=1e8, mem_bytes=_EP_PAIRS * 16,
                     parallel_eff=0.99, vector_friendly=0.9, net_eff=0.5),
    # IS: integer bucket sort; all-to-all dominated, little compute
    "IS": JobProfile("IS", flops=_IS_KEYS * 45,
                     net_bytes=_IS_KEYS * 4 * 10 * 2.2,
                     disk_bytes=2e9, mem_bytes=_IS_KEYS * 4 * 10 * 6,
                     parallel_eff=0.80, vector_friendly=0.3, net_eff=0.15),
    # LU: SSOR wavefront; latency-sensitive pipelined comm, poor overlap
    "LU": JobProfile("LU", flops=_GRID_D * 300 * 2000,
                     net_bytes=300 * 6 * (408 ** 2) * 5 * 8 * 20,
                     disk_bytes=40e9, mem_bytes=_GRID_D * 300 * 600,
                     parallel_eff=0.70, vector_friendly=0.55, net_eff=0.10),
    # SP: scalar pentadiagonal ADI; like BT with more sweeps
    "SP": JobProfile("SP", flops=_GRID_D * 500 * 2800,
                     net_bytes=500 * 6 * (408 ** 2) * 5 * 8 * 12,
                     disk_bytes=50e9, mem_bytes=_GRID_D * 500 * 700,
                     parallel_eff=0.82, vector_friendly=0.7, net_eff=0.4),
}

# Paper Table 6: CNs allocated per system for each benchmark.
NPB_NODES = {
    #        Broadwell  CascadeLake  KNL  Skylake
    "BT": {"Broadwell": 5, "CascadeLake": 3, "KNL": 2, "Skylake": 4},
    "EP": {"Broadwell": 5, "CascadeLake": 3, "KNL": 2, "Skylake": 4},
    "IS": {"Broadwell": 8, "CascadeLake": 6, "KNL": 4, "Skylake": 8},
    "LU": {"Broadwell": 8, "CascadeLake": 6, "KNL": 4, "Skylake": 8},
    "SP": {"Broadwell": 8, "CascadeLake": 6, "KNL": 4, "Skylake": 8},
}

NPB_CORES = {"BT": 144, "EP": 144, "IS": 256, "LU": 256, "SP": 256}


def npb_tables(systems, programs=("BT", "EP", "IS", "LU", "SP")):
    """Dense (C, T, nodes) tables [P, S] for the NPB suite on the given
    systems — the ground truth the simulator and figures consume."""
    P, S = len(programs), len(systems)
    C = np.zeros((P, S))
    T = np.zeros((P, S))
    N = np.zeros((P, S), np.int32)
    for i, prog in enumerate(programs):
        prof = NPB_PROFILES[prog]
        for j, sys in enumerate(systems):
            n = NPB_NODES[prog][sys.name]
            N[i, j] = n
            C[i, j] = energy_coefficient(prof, sys, n)
            T[i, j] = predict_runtime(prof, sys, n)
    return C, T, N
