"""Computing-system models (the paper's CC_1..CC_n).

The four JSCC RAS systems from the paper's experimental platform
(MVS-10P MP2 KNL / OP BRD / OP SKX / OP CLK).  Cores-per-node are fixed by
the paper's Table 6 (144 cores => KNL 2 CN, BDW 5 CN, SKX 4 CN, CLK 3 CN;
256 cores => 4/8/8/6 CN), which matches the public MVS-10P configurations:
KNL 72c, BDW 32c, SKX 36c, CLK 48c per node.

Power figures are public-TDP-based estimates calibrated per DESIGN.md §11
(exact per-benchmark JSCC power is not published); peak flops are the
nominal double-precision node peaks.  The scheduler only ever consumes
*relative* C/T across systems, which these models fix well.

A second registry models heterogeneous TPU pod tiers for the production
half (LM jobs) — same ComputeSystem abstraction, constants from the
assignment (v5e: 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ComputeSystem:
    name: str
    n_nodes: int               # nodes available to the scheduler
    cores_per_node: int
    peak_flops_node: float     # op/s per node (DP for CPU systems, bf16 for TPU)
    mem_bw_node: float         # B/s
    net_bw_node: float         # B/s injection bandwidth per node
    disk_bw_node: float        # B/s parallel-fs bandwidth per node
    # power model, Watts per node (paper eq. (1): W = E_CALC + E_disk + E_net)
    idle_w: float              # baseline (always drawn while allocated)
    cpu_w: float               # extra during compute phases
    net_w: float               # extra during communication phases
    disk_w: float              # extra during disk phases
    efficiency: float          # sustained fraction of peak for well-vectorized code
    scalar_eff: float = 0.55   # fraction of `efficiency` reachable by scalar-ish code


# --- the paper's experimental platform (JSCC RAS) -------------------------

KNL = ComputeSystem(
    name="KNL", n_nodes=38, cores_per_node=72,
    peak_flops_node=3.0e12, mem_bw_node=400e9,   # MCDRAM
    net_bw_node=12.5e9, disk_bw_node=2e9,
    idle_w=120.0, cpu_w=230.0, net_w=18.0, disk_w=12.0,
    efficiency=0.16, scalar_eff=0.20,  # KNL: wide-SIMD friendly, dies on scalar code
)

BROADWELL = ComputeSystem(
    name="Broadwell", n_nodes=136, cores_per_node=32,
    peak_flops_node=1.33e12, mem_bw_node=153e9,
    net_bw_node=12.5e9, disk_bw_node=2e9,
    idle_w=110.0, cpu_w=290.0, net_w=15.0, disk_w=12.0,
    efficiency=0.14, scalar_eff=0.60,
)

SKYLAKE = ComputeSystem(
    name="Skylake", n_nodes=58, cores_per_node=36,
    peak_flops_node=3.46e12, mem_bw_node=256e9,
    net_bw_node=12.5e9, disk_bw_node=2e9,
    idle_w=130.0, cpu_w=420.0, net_w=15.0, disk_w=12.0,
    efficiency=0.13, scalar_eff=0.50,
)

CASCADE_LAKE = ComputeSystem(
    name="CascadeLake", n_nodes=51, cores_per_node=48,
    peak_flops_node=4.6e12, mem_bw_node=282e9,
    net_bw_node=12.5e9, disk_bw_node=2e9,
    idle_w=135.0, cpu_w=430.0, net_w=15.0, disk_w=12.0,
    efficiency=0.135, scalar_eff=0.50,
)

JSCC_SYSTEMS = (KNL, BROADWELL, SKYLAKE, CASCADE_LAKE)
JSCC_BY_NAME = {s.name: s for s in JSCC_SYSTEMS}


# --- heterogeneous TPU pod tiers (production half) ------------------------
# One "node" = one chip; a pod tier exposes n_nodes chips to the scheduler.

TPU_V5E_POD = ComputeSystem(
    name="tpu-v5e-256", n_nodes=256, cores_per_node=1,
    peak_flops_node=197e12, mem_bw_node=819e9,
    net_bw_node=50e9, disk_bw_node=4e9,
    idle_w=70.0, cpu_w=130.0, net_w=15.0, disk_w=5.0,   # ~200W/chip active
    efficiency=0.55,
)

TPU_V4_POD = ComputeSystem(
    name="tpu-v4-256", n_nodes=256, cores_per_node=1,
    peak_flops_node=275e12, mem_bw_node=1200e9,
    net_bw_node=100e9, disk_bw_node=4e9,
    idle_w=90.0, cpu_w=200.0, net_w=20.0, disk_w=5.0,   # ~310W/chip active
    efficiency=0.50,
)

TPU_V5P_POD = ComputeSystem(
    name="tpu-v5p-128", n_nodes=128, cores_per_node=1,
    peak_flops_node=459e12, mem_bw_node=2765e9,
    net_bw_node=100e9, disk_bw_node=4e9,
    idle_w=100.0, cpu_w=250.0, net_w=20.0, disk_w=5.0,
    efficiency=0.55,
)

TPU_SYSTEMS = (TPU_V5E_POD, TPU_V4_POD, TPU_V5P_POD)
TPU_BY_NAME = {s.name: s for s in TPU_SYSTEMS}

ALL_SYSTEMS = {**JSCC_BY_NAME, **TPU_BY_NAME}
