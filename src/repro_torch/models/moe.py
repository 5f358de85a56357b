"""Mixture-of-Experts FFN (``repro/models/moe.py``): top-k routing in f32,
a sort-based dispatch into a static capacity buffer, grouped expert
products, and a combine in the reference's order.

Per-data-shard dispatch, as the reference's: under ``moe_dispatch=
"shard"`` the tokens are reshaped shard-major into ``dispatch_shards()``
shards ([S, T_loc, d]; 1 without rules, and 1 when S does not divide the
batch), and each shard's stable sort, capacity (``moe_capacity(T_loc)``)
and drops are its own; ``aux`` is the mean over shards of each shard's
Switch loss.  The expert products run over every shard's slots at once
([E, S cap, d], the reference's ``secd,edf->secf``).  Under "global", or
without rules, all tokens of the batch are bucketed together.

Numerics, as the reference computes them:
  - router logits ``x . router`` in f32 from the widened activations,
    softmax in f32, ``torch.topk`` for ``lax.top_k`` (gates renormalised
    over the k picked).  At a tie between two experts' probabilities the
    two may pick different experts (``lax.top_k`` takes the lower index
    first; ``torch.topk`` does not promise an order); the routing flips,
    the output stays a valid MoE output.  Ties of f32 softmax values are
    improbable on real activations;
  - the dispatch order is a *stable* sort of the flat (token, slot)
    expert ids, so the tokens past an expert's capacity, dropped, are the
    same ones as in the reference;
  - the gate and up products are f32 results, the exact products summed
    in f32 (``_f32_bmm``), silu and the gate product in f32, rounded once
    to the model dtype; the down product is in the model dtype;
  - the combine adds each token's k weighted contributions one at a time,
    in the model dtype, in ascending expert id, starting from zero: the
    order of the reference's scatter-add (``out.at[token_idx].add``), whose
    updates come sorted by expert.  No atomics (``index_add_`` on CUDA has
    no fixed order), so the result is the same on every run and device.

Dispatch and combine are gathers, copies and integer scatter-adds
without a host synchronisation (a dropped entry is copied into a scratch
row; ``torch.bincount`` would synchronise on CUDA).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, dot
from repro_torch.sharding.ctx import dispatch_shards


def moe_capacity(tokens_per_shard: int, cfg: ModelConfig) -> int:
    """Slots per expert: tokens x top_k x capacity_factor / experts,
    rounded up to a multiple of 8, at least 8."""
    moe = cfg.moe
    c = int(tokens_per_shard * moe.top_k * moe.capacity_factor
            / moe.n_experts)
    return max(8, -(-c // 8) * 8)


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype):
    """The reference's fan-in draws: ``router`` [d, E] f32, ``wi`` and
    ``wu`` [E, d, f], ``wo`` [E, f, d] in ``dtype``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {
        "router": dense_init(gen, d, (e,), torch.float32),
        "wi": dense_init(gen, d, (e, f), dtype).transpose(0, 1).contiguous(),
        "wu": dense_init(gen, d, (e, f), dtype).transpose(0, 1).contiguous(),
        "wo": dense_init(gen, f, (e, d), dtype).transpose(0, 1).contiguous(),
    }


def _counts(flat, n: int):
    """Occurrences of 0..n-1 in each row of the int tensor ``flat``
    [..., m]: [..., n] int64."""
    return torch.zeros((*flat.shape[:-1], n), dtype=torch.int64,
                       device=flat.device).scatter_add_(
        -1, flat, torch.ones_like(flat))


def _f32_product(a, w):
    """[E, C, k] @ [E, k, n] as an f32 result: the exact products (two
    bf16 values multiply exactly in f32) summed in f32 -- for a CUDA bf16
    pair by cuBLAS's f32-output bf16 product, which reads the bf16 weights
    once; otherwise from the widened operands."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.bmm(a, w, out_dtype=torch.float32)
    return torch.bmm(a.float(), w.float())


class _F32Bmm(torch.autograd.Function):
    """``_f32_product`` with its gradient, which autograd lacks for
    ``bmm``'s ``out_dtype``: each operand's gradient is the f32 product of
    the f32 cotangent and the other operand widened, rounded once to the
    operand's dtype -- the transpose XLA takes of the reference's
    ``preferred_element_type=f32`` einsum."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return _f32_product(a, w)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, w.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.bmm(a.float().transpose(1, 2), g).to(w.dtype)
        return ga, gw


def _f32_bmm(a, w):
    """``_f32_product``, through ``_F32Bmm`` while autograd records."""
    if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
        return _F32Bmm.apply(a, w)
    return _f32_product(a, w)


def route(p, xs, cfg: ModelConfig):
    """Top-k routing of the tokens xs [..., T, d].  Returns (probs [..., T,
    E] f32, ids [..., T, k], gates [..., T, k] f32 renormalised)."""
    probs = torch.softmax(dot(xs, p["router"], f32=True), dim=-1)
    gates, ids = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, ids, gates


def dispatch(ids, cap: int, n_experts: int):
    """The reference's capacity bucketing of the expert ids ``ids`` [...,
    T, k], each leading index (a data shard) on its own.  Returns (order
    [..., T k]: the stable sort by expert, keep [..., T k]: the entry fits
    its expert's capacity, dest [..., T k]: its slot ``expert * cap +
    position`` (slot 0 of its expert when dropped)), all in sorted
    order."""
    flat = ids.flatten(-2)
    order = torch.sort(flat, dim=-1, stable=True).indices
    sorted_ids = torch.gather(flat, -1, order)
    counts = _counts(flat, n_experts)
    starts = torch.cumsum(counts, -1) - counts
    pos = (torch.arange(flat.shape[-1], device=ids.device)
           - torch.gather(starts, -1, sorted_ids))
    keep = pos < cap
    return order, keep, sorted_ids * cap + torch.where(keep, pos, 0)


def n_dispatch_shards(cfg: ModelConfig, b: int, shards: int) -> int:
    """The data shards the tokens of a [b, s, d] batch are bucketed in:
    ``shards`` (the rules' ``dispatch_shards()``) under ``moe_dispatch=
    "shard"``, 1 for "global" or when it does not divide ``b``."""
    n = shards if cfg.moe_dispatch == "shard" else 1
    return n if b % n == 0 else 1


def apply_moe(p, x, cfg: ModelConfig, shards: int | None = None):
    """x: [b, s, d].  Returns (out [b, s, d] in x's dtype, aux: the Switch
    load-balance loss averaged over the dispatch shards, an f32
    scalar).  ``shards``: the rules' ``dispatch_shards()``, read by the
    caller outside any checkpointed region (a recompute in backward may
    run on autograd's device thread, which does not see this thread's
    rules); None reads them here."""
    b, s, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    n = n_dispatch_shards(cfg, b, dispatch_shards() if shards is None
                          else shards)
    t = (b // n) * s                                      # tokens a shard
    cap = moe_capacity(t, cfg)
    xs = x.reshape(n, t, d)                               # shard-major

    probs, ids, gates = route(p, xs, cfg)
    ce = _counts(ids.reshape(n, t * k), e).float() / (t * k)
    aux = (e * torch.sum(probs.mean(1) * ce, -1)).mean()

    order, keep, dest = dispatch(ids, cap, e)
    shard = torch.arange(n, device=x.device)[:, None]
    token_idx = order // k + shard * t                    # into [S T]
    # the capacity buffer [E, S cap, d], expert-major: each kept entry
    # copied to its shard's slot, a dropped one to the scratch row
    # e * S * cap; an entry reads back its slot (a dropped one slot 0 of
    # its expert in its shard)
    dest = (dest // cap) * (n * cap) + shard * cap + dest % cap
    buf = torch.zeros((e * n * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, torch.where(keep, dest, e * n * cap).reshape(-1),
                    xs.reshape(n * t, d)[token_idx.reshape(-1)])
    buf = buf[:-1].view(e, n * cap, d)

    h = (F.silu(_f32_bmm(buf, p["wi"])) * _f32_bmm(buf, p["wu"])).to(x.dtype)
    out_e = torch.bmm(h, p["wo"]).reshape(e * n * cap, d)

    w = torch.gather(gates.reshape(n, t * k), -1, order) * keep   # f32
    back = (out_e[dest.reshape(-1)].float() * w.reshape(-1, 1)).to(x.dtype)
    return combine(back, (order + shard * (t * k)).reshape(-1),
                   k).view(b, s, d), aux


def combine(back, order, k: int):
    """The reference's ``zeros.at[order // k].add(back)``: back [T k, d]
    holds the weighted contributions in sorted (expert-major) order.  Each
    token's k entries, in ascending expert id (ascending sorted position),
    are added one at a time in back's dtype from zero.  Returns [T, d]."""
    n, d = back.shape
    where = torch.empty_like(order)
    where[order] = torch.arange(n, device=back.device)
    slots = torch.sort(where.view(n // k, k), dim=1).values
    out = torch.zeros((n // k, d), dtype=back.dtype, device=back.device)
    for j in range(k):
        out = out + back[slots[:, j]]
    return out
