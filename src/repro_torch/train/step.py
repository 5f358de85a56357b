"""Train and serve step factories (``repro/train/step.py``).

``make_train_step`` takes the gradient of ``api.train_loss`` with
``torch.autograd.grad`` (the params are read through leaves that require
grad; nothing is written into them) and applies ``adamw_update``.
Gradients come out in the param dtype, as ``jax.grad``'s do, and
``adamw_update`` widens them.  With ``microbatches > 1`` the batch is
split on dim 0, each microbatch's gradient added in f32 in microbatch
order, and the sums multiplied by ``1 / microbatches``, as the
reference's ``lax.scan`` does; its metrics then report the mean total
loss (the aux term included) and ``tokens`` 0, as the reference's do.
"""

from __future__ import annotations

import torch

from repro_torch.models import ModelApi
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.utils.tree import flatten_with_names, map_with_names


def loss_and_grads(loss_fn, params, batch):
    """(``loss_fn(params, batch)``'s output, the gradient of its loss with
    respect to every leaf of ``params``, in the leaves' dtypes, as a tree
    like ``params``).  ``loss_fn`` returns the loss or (loss, metrics);
    the params are read through leaves that require grad and nothing is
    written into them."""
    flat = [(n, t.detach().requires_grad_(True))
            for n, t in flatten_with_names(params)]
    leaves = dict(flat)
    out = loss_fn(map_with_names(lambda n, _: leaves[n], params), batch)
    loss = out[0] if isinstance(out, tuple) else out
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    return out, map_with_names(lambda n, _: grads[n], params)


def value_and_grad(api: ModelApi, params, batch, force=None):
    """(loss, metrics, grads): ``api.train_loss`` (``force`` to its
    kernel dispatch) and its gradient with respect to every leaf of
    ``params``, in the leaves' dtypes, as a tree like ``params``."""
    (loss, metrics), grads = loss_and_grads(
        lambda p, b: api.train_loss(p, b, force=force), params, batch)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(api: ModelApi, ocfg: AdamWConfig, microbatches: int = 1):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)`` with metrics ``loss``, ``aux``, ``lr`` and ``grad_norm``
    (f32 scalar tensors)."""
    model_dtype = getattr(torch, api.cfg.dtype)

    def compute_grads(params, batch):
        if microbatches == 1:
            return value_and_grad(api, params, batch)

        def split(x):
            b = x.shape[0]
            assert b % microbatches == 0, (b, microbatches)
            return x.reshape(microbatches, b // microbatches, *x.shape[1:])

        mbs = {k: split(v) for k, v in batch.items()}
        gsum = map_with_names(lambda _, t: torch.zeros(
            t.shape, dtype=torch.float32, device=t.device), params)
        dev = flatten_with_names(params)[0][1].device
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        asum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(microbatches):
            loss, metrics, g = value_and_grad(
                api, params, {k: v[i] for k, v in mbs.items()})
            flat = dict(flatten_with_names(g))
            for n, acc in flatten_with_names(gsum):
                acc.add_(flat[n])               # in f32, in microbatch order
            lsum = lsum + loss
            asum = asum + metrics["aux"]
        inv = 1.0 / microbatches
        grads = map_with_names(lambda _, g: g * inv, gsum)
        return lsum * inv, {"loss": lsum * inv, "aux": asum * inv,
                            "tokens": torch.zeros_like(lsum)}, grads

    def train_step(params, opt_state, batch):
        _, metrics, grads = compute_grads(params, batch)
        new_params, new_opt, om = adamw_update(grads, opt_state, ocfg,
                                               model_dtype)
        return new_params, new_opt, {"loss": metrics["loss"],
                                     "aux": metrics["aux"], "lr": om["lr"],
                                     "grad_norm": om["grad_norm"]}

    return train_step


def make_eval_step(api: ModelApi):
    """``eval_step(params, batch) -> metrics`` of ``api.train_loss``, no
    gradient (the kernels run as in serving)."""
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = api.train_loss(params, batch)
        return metrics
    return eval_step


def make_prefill_step(api: ModelApi):
    return api.prefill


def make_decode_step(api: ModelApi):
    return api.decode_step
