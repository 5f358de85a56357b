"""The paper's selection algorithm as the reference's historical
mode-string surface (``repro/core/algorithm.py``): a thin shim over the
port's policy registry.

Paper §Algorithm, for one job of program p: look up C[p, s] and T[p, s]
from previous runs (0 if never run); pick the system with the smallest C
subject to T[p, s] <= min_s' T[p, s'] * (1 + K) (tie -> smaller T); while
some systems are unexplored, the job goes to the first released
unexplored system.  ``MODES`` are the nine historical registry entries.
"""

from __future__ import annotations

from repro_torch.core.policy import LEGACY_MODES, make_policy, select
from repro_torch.utils import prng

MODES = LEGACY_MODES


def select_system(mode: str, *, c_row, t_row, runs_row, avail_row, k,
                  c_pred_row=None, t_pred_row=None, key=None):
    """Return the selected system index (0-dim int64 tensor) for one job.

    Equivalent to the policy registry's ``select(make_policy(mode), ...)``
    with the historical default hyperparameters.  c_row/t_row: learned
    tables for this program [S]; runs_row: run counts [S]; avail_row:
    earliest start per system [S]; k: allowed runtime-increase fraction;
    *_pred_row: model predictions [S]; key: a ``utils.prng`` key (the
    ``random`` objective draws ``randint(key, (), 0, S)`` from it, as the
    reference draws from its ``jax.random`` key).
    """
    policy = make_policy(mode)
    draw = None
    if policy.objective == "random":
        draw = prng.randint(key, (), 0, c_row.shape[-1])
    return select(policy, c_row=c_row, t_row=t_row, runs_row=runs_row,
                  avail_row=avail_row, k=k, c_pred_row=c_pred_row,
                  t_pred_row=t_pred_row, draw=draw)
