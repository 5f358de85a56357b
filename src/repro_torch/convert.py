"""Carry the reference's state across to the port.

The scheduler has no trained weights: its state is the workload tables
and the policy leaves.  Both converters are duck-typed (any object with
the reference's fields as numpy arrays or floats will do), so the port
never imports the reference package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.engine import Workload
from repro_torch.core.policy import Policy

_ARRAY_FIELDS = ("prog", "arrival", "k_job", "n_req", "T_true", "C_true",
                 "E_true", "T_pred", "C_pred", "n_nodes")
_OPTIONAL_FIELDS = ("outage", "idle_w", "T_comp", "E_comp")


def workload_from_reference(w) -> Workload:
    """The port's ``Workload`` with the same arrays as ``w``."""
    kw = {f: np.array(getattr(w, f)) for f in _ARRAY_FIELDS}
    for f in _OPTIONAL_FIELDS:
        v = getattr(w, f, None)
        kw[f] = None if v is None else np.array(v)
    kw["programs"] = tuple(getattr(w, "programs", ()))
    kw["systems"] = tuple(getattr(w, "systems", ()))
    return Workload(**kw)


def policy_from_reference(p) -> Policy:
    """The port's ``Policy`` with the same metadata and leaves as ``p``
    (leaves as numpy arrays, or floats when scalar)."""
    kw = {f.name: getattr(p, f.name) for f in dataclasses.fields(Policy)}
    for leaf in ("k", "ucb_scale", "power_cap", "freq_weight"):
        v = np.array(kw[leaf])
        kw[leaf] = float(v) if v.ndim == 0 else v
    return Policy(**kw)
