"""Carry the reference's state across to the port.

The scheduler has no trained weights: its state is the workload tables
and the policy leaves.  The LM stack's state is its parameter pytree.
Every converter is duck-typed (any object with the reference's fields,
or any dict of the reference's keys, holding numpy arrays or floats will
do), so the port never imports the reference package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import Workload
from repro_torch.core.policy import Policy
from repro_torch.models.transformer import group_size, n_groups
from repro_torch.utils.tree import map_with_names

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


def _tensor(a):
    """A numpy array (bf16 ones from ``ml_dtypes`` included) as a tensor
    with the same values and dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_reference(cfg, tree, device=None):
    """The port's LM parameters with exactly the values of the
    reference's pytree ``tree`` (numpy arrays).  Decoder-only: ``embed/
    table`` [V, d], ``head/w`` [V, d] (absent when tied), ``final_norm``
    and the stacked ``groups/pos{j}/...`` leaves [n_groups, ...] (MoE
    layers' ``moe/{router,wi,wu,wo}`` among them), unstacked into the
    port's per-layer list (layer ``gi * group_size + j``).
    Encoder-decoder: ``embed``, ``head``, ``enc_pos``, ``dec_pos``,
    ``enc_final_norm``, ``dec_final_norm`` as they are, and the stacked
    ``enc_layers`` / ``dec_layers`` [L, ...] as per-layer lists."""
    def conv(node, index=None):
        if isinstance(node, dict):
            return {k: conv(v, index) for k, v in node.items()}
        a = np.asarray(node)
        return _tensor(a if index is None else a[index]).to(device)

    if cfg.is_encoder_decoder:
        out = {k: conv(tree[k]) for k in ("embed", "enc_pos", "dec_pos",
                                          "enc_final_norm",
                                          "dec_final_norm")}
        out["head"] = conv(tree.get("head", {}))
        out["enc_layers"] = [conv(tree["enc_layers"], i)
                             for i in range(cfg.n_encoder_layers)]
        out["dec_layers"] = [conv(tree["dec_layers"], i)
                             for i in range(cfg.n_layers)]
        return out
    groups = tree["groups"]
    g = group_size(cfg)
    layers = [conv(groups[f"pos{j}"], gi) for gi in range(n_groups(cfg))
              for j in range(g)]
    return {"embed": conv(tree["embed"]), "head": conv(tree.get("head", {})),
            "final_norm": conv(tree["final_norm"]), "layers": layers}


def opt_state_from_reference(cfg, opt_tree, device=None):
    """The port's AdamW state from the reference's ``{"master", "m", "v",
    "step"}`` (numpy leaves): each of the three trees through
    ``params_from_reference``'s layout map, f32, and ``step`` an int32
    scalar tensor."""
    out = {k: map_with_names(lambda _, t: t.float(),
                             params_from_reference(cfg, opt_tree[k], device))
           for k in ("master", "m", "v")}
    out["step"] = torch.tensor(int(np.asarray(opt_tree["step"])),
                               dtype=torch.int32, device=device)
    return out


def err_state_from_reference(cfg, per_pod_trees, device=None):
    """The data-parallel trainer's residuals (``train.dp``: one f32 tree per
    pod, in pod order) from the reference's per-pod residual trees (numpy
    leaves in its stacked layout; its ``err_state`` array holds pod p's on
    the devices of pod p), each through ``params_from_reference``'s
    layout map."""
    return [map_with_names(lambda _, t: t.float(),
                           params_from_reference(cfg, tree, device))
            for tree in per_pod_trees]
