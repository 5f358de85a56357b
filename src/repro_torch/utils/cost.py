"""First-order cost of one LM step on a device mesh, counted without a
device: the port's counterpart of ``repro/utils/hlo_cost.py``.

The reference compiles each cell and walks the optimized HLO.  The port
compiles nothing, so it has no HLO text to walk, and ``repro/utils/hlo.py``
(the collective census of that text) has no counterpart here.  This
module counts the same three quantities from the model and the partition
specs instead, on ``meta`` tensors (shapes and dtypes, no storage), so
nothing in it asks for CUDA:

  flops:
    ``torch.utils.flop_counter.FlopCounterMode`` over the model's own
    code: the forward for prefill and decode; forward and backward for
    train, which includes the remat recompute of every layer (the
    checkpoint reruns the layer in backward, up to the last tensor the
    backward saved).  Attention is taken by
    formula, not walked (the blocked plain version's tile loop does not
    end in reasonable time at 32k positions): each attention call of the
    prefill or train forward is recorded at its shapes and costs
    4 hd per (query, key) pair the mask keeps, per batch row and query
    head (the two products, as ``attention_work``); the backward costs
    twice its forward.  Decode attention (one query against the cache)
    is counted by the counter.
    Per device: the total over ``mesh.size`` (work assumed evenly
    partitioned; replicated work is not counted).
  memory bytes per device (HBM traffic, first order):
    weights      per-shard parameter bytes, read once a pass (train: the
                 forward, recompute and backward passes, plus the
                 gradient written and the parameter rewritten)
    optimizer    per-shard AdamW state (f32 master, m, v), read and
                 written once a train step
    cache        per-shard decode cache bytes, read once a step
    activations  the residual stream at each layer boundary, read and
                 written once a pass ([tokens per batch shard, d_model]
                 in the model dtype; train: forward, recompute and a
                 backward of twice the traffic); train adds the f32
                 logits, written and read in forward and backward
    attention    the flash kernel's streams: Q, K, V read and O written
                 once per call (train: the backward twice the forward),
                 total over ``mesh.size``; also reported alone as
                 ``attn_interior_bytes``
  collectives (output bytes per op kind, times the ring-algorithm link
  factor of ``repro/utils/hlo.py``: all-reduce 2x, others 1x):
    all-reduce   each layer block (attn, mlp, moe, mamba, xattn) whose
                 weights are split on the 'model' axis reduces its output
                 [tokens per batch shard, d_model] once a pass; train also
                 reduces each unsplit gradient shard over the data axes
    all-gather   a parameter split on a data axis (FSDP) is gathered once
                 a pass
    reduce-scatter  its gradient is scattered back to the shard
    all-to-all   an MoE layer with experts on 'model' sends each token's
                 top_k rows out and back once a pass
  Decode's sequence-sharded softmax combine and the vocabulary-split
  logits' reductions are [tokens]-sized and left out.

This is a first-order model: no cache reuse, no fusion, no padding.  The
roofline (``launch/roofline.py``) asks nothing finer of it.
"""

from __future__ import annotations

import math
import types
from contextlib import contextmanager, nullcontext

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.models import attention as A
from repro_torch.sharding.ctx import use_rules
from repro_torch.sharding.params import _axis_size, _fit, axis_sizes
from repro_torch.utils.tree import flatten_with_names

#: output bytes -> bytes over each device's links (bandwidth-optimal rings)
LINK_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}


def attention_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the mask keeps: every one, or under the causal
    mask (query i sees keys 0..i) ``sum(min(i + 1, sk) for i < sq)``."""
    if not causal:
        return sq * sk
    m = min(sq, sk)
    return m * (m + 1) // 2 + (sq - m) * sk


def attention_work(b, sq, sk, h, kv, hd, causal, itemsize):
    """(bytes, operations) of one attention call: q, k, v read once and
    the output written once; 4 hd operations per (query, key) pair kept."""
    return (itemsize * b * hd * (2 * sq * h + 2 * sk * kv),
            4 * hd * b * h * attention_pairs(sq, sk, causal))


class _AttentionLedger:
    """Attention work of the calls ``attn_forward`` makes, by phase: the
    forward, and the recompute (calls made while the backward runs)."""

    def __init__(self):
        self.phase = "forward"
        self.flops = {"forward": 0, "recompute": 0}
        self.bytes = {"forward": 0, "recompute": 0}

    def __call__(self, q, k, v, causal=True, **_):
        b, sq, h, hd = q.shape
        nbytes, ops = attention_work(b, sq, k.shape[1], h, k.shape[2], hd,
                                     causal, q.element_size())
        self.flops[self.phase] += ops
        self.bytes[self.phase] += nbytes
        # q's shape and a path to every input, at no counted cost
        return q + (k.sum() + v.sum()).to(q.dtype) * 0


@contextmanager
def _attention_by_formula(ledger):
    """Route ``models.attention.attn_forward``'s attention (the flash
    branch and the plain one) to ``ledger`` for the duration."""
    ops, plain = A.ops, A.plain_attention
    A.ops = types.SimpleNamespace(flash_attention=ledger)
    A.plain_attention = ledger
    try:
        yield
    finally:
        A.ops, A.plain_attention = ops, plain


def count_flops(api, shape, *, mesh=None, rules=None) -> dict:
    """FLOPs of one step of ``shape`` (the ``ShapeConfig``'s kind) on
    ``api``'s model at global size, on meta tensors: ``counted`` by the
    counter, ``attention`` by formula (forward, recompute and backward
    for train), their sum ``flops``, and the attention streams' bytes
    ``attn_bytes``.  With ``mesh`` and ``rules`` the step runs under
    them (the MoE dispatch buckets per data shard)."""
    params = api.param_specs()
    inputs = api.input_specs(shape)
    ledger = _AttentionLedger()
    ctx = use_rules(mesh, rules) if rules else nullcontext()
    with ctx, _attention_by_formula(ledger), \
            FlopCounterMode(display=False) as counter:
        if shape.kind == "prefill":
            api.prefill(params, inputs["batch"])
        elif shape.kind == "decode":
            api.decode_step(params, inputs["cache"], inputs["tokens"],
                            shape.seq_len - 1)
        else:
            for _, x in flatten_with_names(params):
                x.requires_grad_(x.is_floating_point())
            loss, _ = api.train_loss(params, inputs["batch"])
            ledger.phase = "recompute"
            loss.backward()
    train = shape.kind == "train"
    fwd, rec = ledger.flops["forward"], ledger.flops["recompute"]
    attn = fwd + rec + (2 * fwd if train else 0)
    bfwd, brec = ledger.bytes["forward"], ledger.bytes["recompute"]
    attn_bytes = bfwd + brec + (2 * bfwd if train else 0)
    counted = int(counter.get_total_flops())
    return {"counted": counted, "attention": attn, "flops": counted + attn,
            "attn_bytes": attn_bytes}


def shard_bytes(tree, part_tree, sizes: dict) -> int:
    """Bytes of one shard of every leaf of ``tree`` (meta tensors) under
    the PartitionSpec tree ``part_tree``: each dim split over the product
    of its mesh axes (rounded up)."""
    parts = dict(flatten_with_names(part_tree))
    total = 0
    for name, x in flatten_with_names(tree):
        spec = tuple(parts.get(name) or ())
        n = 1
        for i, d in enumerate(x.shape):
            ax = spec[i] if i < len(spec) else None
            n *= math.ceil(d / _axis_size(ax, sizes))
        total += n * x.element_size()
    return total


def _split(spec, axes, sizes) -> int:
    """How many ways a PartitionSpec splits a leaf over the mesh axes
    ``axes`` (1: not at all)."""
    n = 1
    for part in spec:
        names = () if part is None else (
            (part,) if isinstance(part, str) else tuple(part))
        for a in names:
            if a in axes:
                n *= sizes[a]
    return n


def _blocks(param_part) -> dict:
    """Layer block path (``layers/3/attn``) -> the specs of its leaves."""
    out = {}
    for name, spec in flatten_with_names(param_part):
        parts = name.split("/")
        if parts[0] in ("layers", "enc_layers", "dec_layers") \
                and len(parts) > 3:
            out.setdefault("/".join(parts[:3]), []).append(spec)
    return out


def cell_cost(api, shape, specs: dict, mesh) -> dict:
    """The dry-run record's cost of one (model, shape, mesh) cell from
    ``launch.specs.build_all_specs``' trees: FLOPs, memory bytes and
    collective link bytes per device (the model in this module's
    docstring), and the per-shard ``argument_bytes`` of parameters,
    optimizer state and inputs."""
    cfg = api.cfg
    sizes = axis_sizes(mesh)
    n_dev = mesh.size
    rules = specs["rules"]
    train = shape.kind == "train"
    remat = train and cfg.remat_policy != "none"
    passes = (3 if remat else 2) if train else 1       # weight/layer passes
    act_passes = passes + 1 if train else 1            # backward counts 2x
    itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()

    batch_shards = _axis_size(_fit(shape.global_batch, rules["batch"], sizes),
                              sizes)
    b_loc = shape.global_batch / batch_shards
    s = 1 if shape.kind == "decode" else shape.seq_len
    s_dec = s + (cfg.n_patches if cfg.frontend == "vision"
                 and shape.kind != "decode" else 0)
    tokens_loc = b_loc * s_dec
    layers = [(cfg.n_layers, tokens_loc)]
    if cfg.is_encoder_decoder and shape.kind != "decode":
        layers.append((cfg.n_encoder_layers, b_loc * cfg.encoder_seq))

    flops = count_flops(api, shape, mesh=mesh, rules=rules)
    weights = shard_bytes(specs["param_specs"], specs["param_part"], sizes)
    inputs = specs["inputs"]
    if shape.kind == "decode":
        cache = shard_bytes(inputs["cache"], specs["cache_part"], sizes)
        in_bytes = cache + shard_bytes(
            {"tokens": inputs["tokens"]},
            {"tokens": (_fit(shape.global_batch, rules["batch"], sizes),
                        None)}, sizes)
    else:
        cache = 0
        in_bytes = shard_bytes(inputs["batch"], specs["batch_part"], sizes)
    opt = shard_bytes(specs["opt_specs"], specs["opt_part"], sizes) \
        if train else 0

    by_part = {
        "weights": weights * (passes + 2 if train else 1),
        "optimizer": 2 * opt,
        "cache": cache,
        "activations": sum(2 * n * t * cfg.d_model * itemsize * act_passes
                           for n, t in layers),
        "attention": flops["attn_bytes"] / n_dev,
    }
    if train:
        vocab_loc = cfg.vocab_size / _axis_size(
            _fit(cfg.vocab_size, rules["vocab"], sizes), sizes)
        by_part["logits"] = 2 * 2 * tokens_loc * vocab_loc * 4

    # collectives, by output bytes per op kind
    out = {op: 0.0 for op in LINK_FACTOR}
    batch_axes = ((rules["batch"],) if isinstance(rules["batch"], str)
                  else tuple(rules["batch"]))
    for block, bspecs in _blocks(specs["param_part"]).items():
        if all(_split(sp, ("model",), sizes) == 1 for sp in bspecs):
            continue
        if block.startswith("enc_"):
            if len(layers) == 1:
                continue             # decode: the encoder does not run
            t = layers[1][1]
        else:
            t = tokens_loc
        out["all-reduce"] += passes * t * cfg.d_model * itemsize
        if block.endswith("/moe"):
            out["all-to-all"] += (passes * 2 * t * cfg.moe.top_k
                                  * cfg.d_model * itemsize)
    parts = dict(flatten_with_names(specs["param_part"]))
    for name, x in flatten_with_names(specs["param_specs"]):
        spec = parts[name]
        one = shard_bytes({"x": x}, {"x": spec}, sizes)
        fsdp = _split(spec, batch_axes, sizes)
        if fsdp > 1:
            out["all-gather"] += passes * one * fsdp
            if train:
                out["reduce-scatter"] += one
        elif train and batch_shards > 1:
            out["all-reduce"] += one
    link = sum(out[op] * LINK_FACTOR[op] for op in out)
    return {
        "flops_per_device": flops["flops"] / n_dev,
        "flops_total": flops["flops"],
        "counted_flops_total": flops["counted"],
        "attn_flops_total": flops["attention"],
        "mem_bytes_per_device": float(sum(by_part.values())),
        "mem_bytes_by_part": by_part,
        "attn_interior_bytes": by_part["attention"],
        "coll_link_bytes_per_device": link,
        "coll_output_bytes_per_op": out,
        "argument_bytes": weights + opt + in_bytes,
    }
