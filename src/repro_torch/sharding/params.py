"""Parameter partition rules: path + shape -> PartitionSpec
(``repro/sharding/params.py``).

Megatron-style TP on the 'model' axis (heads / ff / experts / vocab),
optional ZeRO/FSDP on the 'data' axis (embed dims), with a divisibility
fallback: an axis is assigned only if it divides the dim (llama4's 40
q-heads and qwen2's 12 do not divide a 16-way model axis, so those
weights fall back to FSDP).

The port's parameter tree is per layer (``layers/<i>/attn/wq``,
``enc_layers/<i>/...``), the reference's stacked (``groups/pos<j>/...``
with a leading group dim).  So a port leaf's spec is the reference's spec
of its counterpart without the stacked leading None.
"""

from __future__ import annotations

from repro_torch.sharding.ctx import PartitionSpec as P
from repro_torch.utils.tree import map_with_names


def _axis_size(ax, axis_sizes) -> int:
    if ax is None:
        return 1
    names = (ax,) if isinstance(ax, str) else tuple(ax)
    n = 1
    for a in names:
        n *= axis_sizes[a]
    return n


def _fit(dim: int, ax, axis_sizes):
    """Return ax if it divides dim, else None."""
    return ax if (ax is not None
                  and dim % _axis_size(ax, axis_sizes) == 0) else None


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def logical_axes_for(path: str, ndim: int) -> tuple:
    """Map a param path to logical axis names (pre-divisibility-check)."""
    parts = path.split("/")
    name = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""

    if name == "table":                       # embed [V, d]
        return ("vocab", "embed")
    if parent == "head" and name == "w":      # lm head [V, d]
        return ("vocab", "embed")
    if name in ("enc_pos", "dec_pos"):
        return (None, "embed")

    if parent in ("attn", "xattn"):
        if name == "wq":
            return ("embed", "heads", None)
        if name in ("wk", "wv"):
            return ("embed", "kv_heads", None)
        if name == "wo":
            return ("heads", None, "embed")
        if name == "bq":
            return ("heads", None)
        if name in ("bk", "bv"):
            return ("kv_heads", None)

    if parent == "moe":
        if name == "router":
            return ("embed", None)
        # experts consume the 'model' axis (EP); ff must NOT also map to it
        if name in ("wi", "wu"):
            return ("experts", "embed", None)
        if name == "wo":
            return ("experts", None, "embed")

    if parent == "mlp":
        if name in ("wi", "wu"):
            return ("embed", "ff")
        if name == "wo":
            return ("ff", "embed")
        if name == "bi":
            return ("ff",)
        if name == "bo":
            return ("embed",)

    if parent == "mamba":
        if name == "in_proj":
            return ("embed", None)
        if name == "out_proj":
            return (None, "embed")
        # conv_w/conv_b/dt_bias/A_log/D/norm_scale: replicate
        return (None,) * ndim

    # norms & anything else: replicated
    return (None,) * ndim


def param_partition_spec(path: str, shape: tuple, rules: dict,
                         axis_sizes: dict) -> P:
    """The spec of the port's leaf ``path`` (no stacked dim)."""
    logical = logical_axes_for(path, len(shape))
    if len(logical) != len(shape):
        logical = (None,) * len(shape)
    mesh_axes = [rules.get(name) if name else None for name in logical]
    return P(*(_fit(d, ax, axis_sizes) for d, ax in zip(shape, mesh_axes)))


def tree_partition_specs(spec_tree, rules, mesh):
    """Map a tree of tensors (``param_specs``' meta tensors) to a tree of
    PartitionSpecs."""
    sizes = axis_sizes(mesh)
    return map_with_names(lambda name, x: param_partition_spec(
        name, tuple(x.shape), rules, sizes), spec_tree)
