"""Input, cache and state sharding specs (``repro/launch/specs.py``).

The port's decode cache is stacked by layer kind (``k`` / ``v`` [La, b, S,
kv, hd], ``conv`` [Lm, ...], ``state`` [Lm, ...]) where the reference's is
stacked by group position; each leaf's spec depends on its name and its
trailing dims only, so it equals the reference's for the counterpart.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.sharding.ctx import NamedSharding, lm_rules
from repro_torch.sharding.ctx import PartitionSpec as P
from repro_torch.sharding.params import _fit, axis_sizes, tree_partition_specs
from repro_torch.utils.tree import map_with_names


def batch_partition_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, rules):
    """PartitionSpec tree matching ``ModelApi.input_specs()['batch']``."""
    bax = _fit(shape.global_batch, rules["batch"], axis_sizes(mesh))
    specs = {"tokens": P(bax, None)}
    if shape.kind == "train":
        specs["labels"] = P(bax, None)
        specs["mask"] = P(bax, None)
    if cfg.is_encoder_decoder:
        specs["frame_embeds"] = P(bax, None, None)
    if cfg.frontend == "vision":
        specs["patch_embeds"] = P(bax, None, None)
    return specs


def cache_partition_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, rules,
                          cache_specs):
    """PartitionSpec tree matching ``decode_cache_specs``.

    Attention KV caches [.., b, S, kv, hd]: batch on the data axes when it
    divides; kv heads on 'model' when they divide, otherwise the SEQUENCE
    dim goes on 'model' (flash-decode style partial softmax).  For
    global_batch=1 long-context, sequence is sharded over (data, model)
    jointly.
    """
    sizes = axis_sizes(mesh)
    b = shape.global_batch
    bax = _fit(b, rules["batch"], sizes)

    def spec_for_leaf(path: str, x):
        nd = len(x.shape)
        name = path.split("/")[-1]
        if name in ("k", "v", "self_k", "self_v", "mem_k", "mem_v"):
            stacked = 1 if nd == 5 else 0
            kv_ax = _fit(x.shape[stacked + 2], rules["kv_heads"], sizes)
            if kv_ax is not None:
                seq_ax = None
            else:
                # sequence sharding fallback; join data axes when batch=1
                seq_ax = (("data", "model") if (bax is None or b == 1)
                          else "model")
                seq_ax = _fit(x.shape[stacked + 1], seq_ax, sizes)
            return P(*([None] * stacked + [bax, seq_ax, kv_ax, None]))
        if name == "conv":       # [L, b, K-1, conv_dim]
            cd_ax = _fit(x.shape[-1], rules["ff"], sizes)
            return P(*([None] * (nd - 3) + [bax, None, cd_ax]))
        if name == "state":      # [L, b, h, p, n]
            h_ax = _fit(x.shape[-3], rules["heads"], sizes)
            return P(*([None] * (nd - 4) + [bax, h_ax, None, None]))
        return P(*([None] * nd))

    return map_with_names(spec_for_leaf, cache_specs)


def named(mesh, spec_tree):
    """Each spec of ``spec_tree`` as a ``NamedSharding`` on ``mesh``."""
    return map_with_names(lambda _, s: NamedSharding(mesh, s), spec_tree)


def build_all_specs(api, shape: ShapeConfig, mesh, *, multi_pod: bool):
    """The cell's input stand-ins (meta tensors) and sharding trees."""
    from repro_torch.optim import adamw_init_specs
    cfg = api.cfg
    rules = lm_rules(multi_pod, cfg.fsdp)
    inputs = api.input_specs(shape)
    out = {"rules": rules, "inputs": inputs}

    pspecs = api.param_specs()
    out["param_specs"] = pspecs
    out["param_part"] = tree_partition_specs(pspecs, rules, mesh)

    if shape.kind == "train":
        out["opt_specs"] = adamw_init_specs(pspecs)
        out["opt_part"] = {"master": out["param_part"],
                           "m": out["param_part"],
                           "v": out["param_part"], "step": P()}
        out["batch_part"] = batch_partition_specs(cfg, shape, mesh, rules)
    elif shape.kind == "prefill":
        out["batch_part"] = batch_partition_specs(cfg, shape, mesh, rules)
    else:  # decode
        out["cache_part"] = cache_partition_specs(
            cfg, shape, mesh, rules, inputs["cache"])
    return out
