"""Int8 error-feedback gradient compression for the cross-pod reduction
(``repro/optim/compression.py``).

At multi-pod scale the only inter-pod training traffic is the
data-parallel gradient all-reduce.  Compressing it to int8 halves its
bytes against bf16; error feedback (each member keeps the residual its
quantization dropped and adds it to its next gradient) keeps SGD
converging.  Per-tensor symmetric quantization.

The reference's ``compressed_psum`` runs inside ``shard_map`` with a named
axis.  The port runs the members of the axis in one process, so
``compressed_psum`` takes them all: one gradient tree and one residual
tree per member, in the axis's order.
"""

from __future__ import annotations

import torch

from repro_torch.utils.tree import flatten_with_names, map_with_names

# the parameter lists that hold one entry per layer (``layers/<i>/...``)
LAYER_LISTS = ("layers", "enc_layers", "dec_layers")


def quantize_int8(x, amax=None):
    """Per-tensor symmetric int8 quantization.  Returns (q int8, scale, an
    f32 scalar tensor).  ``torch.round`` rounds half to even, as
    ``jnp.round`` does.  ``amax``: the max |.| of the tensor ``x`` is a
    slice of (default: ``x``'s own)."""
    if amax is None:
        amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compress_with_feedback(g, err, amax=None):
    """Quantize (g + err) in f32; return (q, scale, new_err).  ``amax`` as
    for ``quantize_int8``."""
    target = g.to(torch.float32) + err
    q, scale = quantize_int8(target, amax)
    return q, scale, target - dequantize_int8(q, scale)


def compressed_psum(grads_per_member, err_per_member, tensor_of=None):
    """All-reduce (mean) a gradient tree over the members of an axis with
    int8 error-feedback compression.  ``grads_per_member`` and
    ``err_per_member``: one tree per member, in the axis's order.  Each
    member quantizes its gradient plus its residual, per tensor; the
    dequantized values are added in f32 in member order and divided by
    the member count (the reference's ``psum(...) / n``).
    ``tensor_of(name)``: the tensor a leaf is a slice of, whose max |.|
    sets the scale of all its slices (the port's per-layer leaves of one
    stacked reference leaf, ``ModelApi.stacked_name``).  A tree with
    per-layer leaves (``layers/<i>/...``, ``enc_layers/<i>/...``,
    ``dec_layers/<i>/...``) needs it; None is allowed only for a tree
    without them, each leaf its own tensor.  Returns (the mean tree, f32,
    and the members' new residual trees)."""
    n = len(grads_per_member)
    if len(err_per_member) != n:
        raise ValueError(f"{n} gradient trees and {len(err_per_member)} "
                         f"residual trees")
    if tensor_of is None:
        layered = [name for name, _ in flatten_with_names(grads_per_member[0])
                   if name.split("/")[0] in LAYER_LISTS]
        if layered:
            raise ValueError(f"per-layer leaves ({layered[0]}, ...) are "
                             f"slices of one stacked tensor: pass tensor_of "
                             f"(ModelApi.stacked_name)")
        tensor_of = lambda name: name  # noqa: E731
    mean, new_errs = {}, []
    for g_tree, e_tree in zip(grads_per_member, err_per_member):
        flat, errs = flatten_with_names(g_tree), dict(flatten_with_names(
            e_tree))
        amax: dict = {}
        for name, g in flat:
            a = torch.max(torch.abs(g.to(torch.float32) + errs[name]))
            t = tensor_of(name)
            amax[t] = a if t not in amax else torch.maximum(amax[t], a)
        new = {}
        for name, g in flat:
            q, scale, new[name] = compress_with_feedback(
                g, errs[name], amax[tensor_of(name)])
            recon = dequantize_int8(q, scale)
            mean[name] = recon if name not in mean else mean[name] + recon
        new_errs.append(new)
    tree = grads_per_member[0]
    return (map_with_names(lambda name, _: mean[name] / n, tree),
            [map_with_names(lambda name, _, e=e: e[name], tree)
             for e in new_errs])


def init_error_state(params):
    """Zero f32 residuals shaped like ``params``."""
    return map_with_names(lambda _, x: torch.zeros(
        x.shape, dtype=torch.float32, device=x.device), params)
