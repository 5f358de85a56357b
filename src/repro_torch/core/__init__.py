"""The port's scheduling core: system and program tables, the policy
family, results and the ``Scheduler`` facade."""

from repro_torch.core.systems import (
    ComputeSystem, JSCC_SYSTEMS, JSCC_BY_NAME, TPU_SYSTEMS, ALL_SYSTEMS,
    KNL, BROADWELL, SKYLAKE, CASCADE_LAKE,
)
from repro_torch.core.workload_model import (
    JobProfile, NPB_PROFILES, NPB_NODES, NPB_CORES, npb_tables,
    predict_runtime, predict_energy, predict_phases, energy_coefficient,
)
from repro_torch.core.policy import (
    Policy, register_policy, make_policy, policy_names, parse_policy_spec,
    parse_queue_spec, select_batched,
    EXPLORATIONS, FEASIBILITIES, OBJECTIVES, QUEUES,
)
from repro_torch.core.result import SimResult, CampaignResult
from repro_torch.core.engine import (FaultConfig, Scheduler, Workload,
                                     make_npb_workload)
