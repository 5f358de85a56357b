"""The port's scheduling core: system and program tables, the policy
family, the profile store and the paper's selection rule, results, the
``Scheduler`` facade and the legacy simulator shims."""

from repro_torch.core.systems import (
    ComputeSystem, JSCC_SYSTEMS, JSCC_BY_NAME, TPU_SYSTEMS, ALL_SYSTEMS,
    KNL, BROADWELL, SKYLAKE, CASCADE_LAKE,
)
from repro_torch.core.workload_model import (
    JobProfile, NPB_PROFILES, NPB_NODES, NPB_CORES, npb_tables,
    predict_runtime, predict_energy, predict_phases, energy_coefficient,
)
from repro_torch.core.profiles import ProfileStore, k_auto
from repro_torch.core.policy import (
    Policy, register_policy, make_policy, policy_names, parse_policy_spec,
    parse_queue_spec, select_batched,
    EXPLORATIONS, FEASIBILITIES, OBJECTIVES, QUEUES,
)
from repro_torch.core.algorithm import select_system, MODES
from repro_torch.core.result import SimResult, CampaignResult
from repro_torch.core.engine import Scheduler
from repro_torch.core.simulator import (
    SimConfig, FaultConfig, Workload, make_npb_workload,
    simulate_jax, simulate_py, sweep_k, run_campaign,
)
from repro_torch.core import energy
