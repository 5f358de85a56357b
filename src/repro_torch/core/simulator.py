"""The legacy simulator surface on the port's engine.

The reference's historical entry points, thin shims over ``Scheduler``:

  - ``simulate_jax(w, scfg)``      == ``Scheduler(policy).run(w)``
  - ``sweep_k(w, scfg, ks)``       == ``Scheduler(policy-with-K-grid).run(w)``
  - ``run_campaign(w, scfg, ...)`` == ``Scheduler(policy, faults, seeds).run(w)``

each returning the result's ``to_dict()`` (per-job tensors, totals and
the derived metrics).  The names are the reference's, so a caller changes
only the package name; each shim also takes ``device=`` (None = CUDA,
``RuntimeError`` without one; "cpu" runs on the CPU).

``simulate_py``, the reference's float64 differential mirror, is not
ported (ROADMAP Queue 1 item 15): it raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.engine import (  # noqa: F401 (re-exports)
    FaultConfig, Scheduler, SimConfig, Workload, make_npb_workload,
)
from repro_torch.core.policy import BIG, UNCAPPED, make_policy  # noqa: F401


def simulate_jax(w: Workload, scfg: SimConfig, *, device=None):
    """One simulation: ``Scheduler(scfg.policy(), ...).run(w).to_dict()``."""
    return _scheduler_for(scfg, device=device).run(w).to_dict()


def sweep_k(w: Workload, scfg: SimConfig, ks, *, device=None):
    """The whole simulation over a K grid in one run (Figs 1-4 are one
    call): a K-grid ``Policy``.  Per-job overrides in ``w.k_job`` win over
    the swept K at their positions."""
    pol = scfg.policy().with_params(k=np.asarray(list(ks), np.float32))
    return _scheduler_for(scfg, policy=pol, device=device).run(w).to_dict()


def run_campaign(w: Workload, scfg: SimConfig, ks=None, seeds=None,
                 faults=None, *, device=None):
    """The (fault-config x K x seed) grid in one run.

    ks:     iterable of K values            (default: [scfg.k])
    seeds:  iterable of PRNG seeds          (default: [scfg.seed])
    faults: iterable of FaultConfig         (default: scfg's fault fields)

    Returns ``simulate_jax``'s dict with leading axes [K, R], or [F, K, R]
    with a fault grid, on every entry.  Per-job K overrides in
    ``w.k_job`` win over the swept K at their positions."""
    ks = [scfg.k] if ks is None else list(ks)
    pol = scfg.policy().with_params(k=np.asarray(ks, np.float32))
    seeds = [scfg.seed] if seeds is None else list(seeds)
    sched = _scheduler_for(scfg, policy=pol, seeds=seeds,
                           faults=None if faults is None else tuple(faults),
                           device=device)
    return sched.run(w).to_dict()


def _scheduler_for(scfg: SimConfig, policy=None, seeds=None, faults=None,
                   device=None):
    """SimConfig -> Scheduler with the legacy axis conventions: the built
    policy carries scfg's queue / window / power_cap overrides, and the
    core override rides separately."""
    return Scheduler(
        scfg.policy() if policy is None else policy,
        placer=scfg.placer, warm_start=scfg.warm_start,
        engine=scfg.core or None,
        seeds=scfg.seed if seeds is None else seeds,
        faults=FaultConfig(
            straggler_prob=scfg.straggler_prob,
            straggler_factor=scfg.straggler_factor,
            failure_prob=scfg.failure_prob,
            restart_overhead=scfg.restart_overhead,
        ) if faults is None else faults,
        device=device)


def simulate_py(w: Workload, scfg: SimConfig):
    """The reference's float64 python mirror: not ported."""
    raise NotImplementedError(
        "simulate_py, the float64 differential mirror, is not ported "
        "(ROADMAP Queue 1 item 15); the reference's own mirror is the "
        "oracle")
