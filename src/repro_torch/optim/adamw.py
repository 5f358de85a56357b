"""AdamW with f32 master weights, global-norm clipping and the LR schedule
(``repro/optim/adamw.py``).

The optimizer state keeps f32 master params and moments whatever the
model dtype is (a bf16 model trains on f32 masters, cast on apply), and
an int32 ``step``; every leaf follows the param dict's layout
(``utils/tree.py``).

Numerics are those of the reference's compiled (jitted) update on the
CPU, which is how its training step runs:
  - ``lr_schedule``: XLA turns each division by a config constant into a
    multiplication by its f32 reciprocal, folds ``0.5 * 0.9`` into one
    constant and fuses ``(1 + cos) * 0.45 + 0.1`` into one multiply-add;
    the port does the same.  The cosine is taken in f64 and rounded once
    (torch's f32 cosine is not correctly rounded; XLA's is but for about
    1 step in 2,000, where the two differ by 1 ulp);
  - the moments are fused multiply-adds, ``m = fma(b1, m, (1 - b1) g)``
    and ``v = fma(b2, v, (1 - b2) g g)``;
  - the update is ``m / (bc1 (sqrt(v / bc2) + eps))`` (XLA's rewrite of
    ``(m / bc1) / (...)``), the decay ``fma(wd, master, q)`` and the step
    ``fma(-lr, x, master)``; the square root and the bias corrections
    ``b ** t`` are taken in f64 and rounded once (correctly rounded, as
    XLA's are; torch's f32 ``sqrt`` on the CPU is not).
With the same gradients, state and schedule the port's update is the
reference's bit for bit; the global norm sums the leaves in another order
(``tests/test_torch_optim.py``).  ``utils.fp.fma`` gives the one rounding
on either device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.utils.fp import fma
from repro_torch.utils.tree import flatten_with_names, map_with_names


@dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _recip(n: int, device):
    """The f32 reciprocal of the config constant ``n`` (XLA's rewrite of a
    division by a constant)."""
    return 1 / _f32(float(n), device)


def lr_schedule(cfg: AdamWConfig, step):
    """Linear warmup + cosine decay to ``lr_min_ratio``; an f32 scalar
    tensor on ``step``'s device (an int gives the CPU)."""
    s = (step.to(torch.float32) if torch.is_tensor(step)
         else _f32(float(step)))
    dev = s.device
    warm = torch.clamp(s * _recip(max(cfg.warmup_steps, 1), dev), max=1.0)
    prog = torch.clamp((s - float(cfg.warmup_steps))
                       * _recip(max(cfg.total_steps - cfg.warmup_steps, 1),
                                dev), 0.0, 1.0)
    cos = torch.cos((prog * math.pi).double()).float()
    frac = fma(cos + 1, _f32((1 - cfg.lr_min_ratio) * 0.5, dev),
               _f32(cfg.lr_min_ratio, dev))
    return (warm * cfg.lr_peak) * frac


def global_norm(tree):
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    sums = [torch.sum(torch.square(x.float()))
            for _, x in flatten_with_names(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def adamw_init(params):
    """``{"master", "m", "v"}`` f32 trees shaped like ``params`` (the
    master a copy of them) and ``"step"``, an int32 0."""
    dev = flatten_with_names(params)[0][1].device
    return {
        "master": map_with_names(lambda _, x: x.detach().float().clone(),
                                 params),
        "m": map_with_names(lambda _, x: torch.zeros(
            x.shape, dtype=torch.float32, device=x.device), params),
        "v": map_with_names(lambda _, x: torch.zeros(
            x.shape, dtype=torch.float32, device=x.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def adamw_init_specs(param_specs):
    """``adamw_init``'s shapes and dtypes as meta tensors (no storage):
    f32 ``master``, ``m`` and ``v`` like ``param_specs`` and an int32
    ``step``."""
    def f32(_, x):
        return torch.empty(x.shape, dtype=torch.float32, device="meta")
    return {"master": map_with_names(f32, param_specs),
            "m": map_with_names(f32, param_specs),
            "v": map_with_names(f32, param_specs),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _pow(b: float, t):
    """``b ** t`` for the f32 base ``b``, correctly rounded to f32."""
    return torch.pow(_f32(b, t.device).double(), t.double()).float()


def _sqrt(x):
    """Correctly rounded f32 square root."""
    return torch.sqrt(x.double()).float()


def adamw_update(grads, opt_state, ocfg: AdamWConfig, model_dtype):
    """Returns (new params in ``model_dtype``, new optimizer state,
    ``{"lr", "grad_norm"}``).  ``grads`` is a tree like the params (any
    float dtype); nothing is updated in place."""
    step = opt_state["step"] + 1
    lr = lr_schedule(ocfg, step)
    g32 = map_with_names(lambda _, g: g.float(), grads)
    gnorm = global_norm(g32)
    scale = torch.clamp(ocfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    b1, b2 = ocfg.b1, ocfg.b2
    t = step.to(torch.float32)
    bc1 = 1 - _pow(b1, t)
    bc2 = 1 - _pow(b2, t)
    names = [n for n, _ in flatten_with_names(g32)]
    leaves = {n: g * scale for n, g in flatten_with_names(g32)}
    m = dict(flatten_with_names(opt_state["m"]))
    v = dict(flatten_with_names(opt_state["v"]))
    master = dict(flatten_with_names(opt_state["master"]))
    new_m, new_v, new_master = {}, {}, {}
    for n in names:
        g = leaves[n]
        new_m[n] = fma(b1, m[n], (1 - b1) * g)
        new_v[n] = fma(b2, v[n], (1 - b2) * g * g)
        q = new_m[n] / (bc1 * (_sqrt(new_v[n] / bc2) + ocfg.eps))
        x = fma(ocfg.weight_decay, master[n], q)
        new_master[n] = fma(-lr, x, master[n])

    def rebuild(flat):
        return map_with_names(lambda name, _: flat[name], grads)
    master_tree = rebuild(new_master)
    new_params = map_with_names(lambda _, x: x.to(model_dtype), master_tree)
    new_state = {"master": master_tree, "m": rebuild(new_m),
                 "v": rebuild(new_v), "step": step}
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}
