"""Hierarchical data-parallel training with compressed cross-pod
gradients (``repro/train/dp.py``).

The reference runs ``shard_map`` over a ``('pod', 'data')`` mesh; the port
runs the mesh's shards one after another in one process, each on its
shard's device (``launch.mesh``), and makes every collective an explicit
reduction over the members of its axis, in the reference's order:

  - each shard takes the value and gradient of ``loss_fn`` on its rows
    of the batch (dim 0 split into pod x data blocks in row-major
    ``(pod, data)`` order, the reference's ``P(("pod", "data"))``); the
    gradients come out in the params' dtypes;
  - intra-pod reduction, ``pmean`` over 'data' as XLA's CPU computes it:
    the members added in f32 in shard order, times the f32 reciprocal of
    their count, rounded once to the gradient's dtype (a bf16 gradient is
    summed in f32, not in bf16 and not pairwise);
  - cross-pod reduction through int8 error feedback
    (``optim.compression``): each pod quantizes its own pod mean plus its
    own residual, per tensor, a tensor being the reference's leaf (its
    stacked layers share one scale); the dequantized pod values are
    added in f32 in pod order and divided by the pod count.  Without compression a ``pmean``
    over 'pod' as above.  The loss is ``pmean`` over 'data', then 'pod';
  - one ``adamw_update`` on the reduced gradients, with the model dtype
    of the params' first leaf in key-sorted order (``embed/table``).

``err_state``: the reference declares it replicated, but each pod keeps
its own residual in its devices' buffers (devices of pod p hold pod p's;
reading the array gives pod 0's).  The port keeps one residual tree per
pod, a list in pod order: ``err_state[0]`` is what the reference's array
reads as.  A single tree (``init_dp_state``'s) is every pod's start.
"""

from __future__ import annotations

import torch

from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compressed_psum, init_error_state)
from repro_torch.sharding.layout import ShardedTensor
from repro_torch.train.step import loss_and_grads
from repro_torch.utils.tree import flatten_with_names, map_with_names

BATCH_SPEC = (("pod", "data"),)


def _recip(n: int) -> float:
    """The f32 reciprocal of ``n`` (XLA's rewrite of a division by a
    constant), as a Python float."""
    return float(torch.tensor(1.0, dtype=torch.float32) / n)


def _sum_into(acc, tree):
    """``acc + tree`` leaf by leaf in f32, in place (``acc`` None: an f32
    copy of ``tree``)."""
    if acc is None:
        return map_with_names(lambda _, t: t.to(torch.float32, copy=True),
                              tree)
    flat = dict(flatten_with_names(tree))
    for n, a in flatten_with_names(acc):
        a.add_(flat[n])
    return acc


def _mean(acc, n: int, like):
    """The f32 sum ``acc`` of ``n`` members times the f32 reciprocal of
    ``n``, rounded once to the dtypes of the tree ``like``."""
    inv, dtypes = _recip(n), dict(
        (k, t.dtype) for k, t in flatten_with_names(like))
    return map_with_names(lambda k, a: (a * inv).to(dtypes[k]), acc)


def pmean(members):
    """The mean of same-shaped trees (or tensors) over an axis's members,
    as XLA's CPU all-reduce computes it: added in f32 in member order,
    times the f32 reciprocal of the count, rounded once to the members'
    dtype."""
    acc = None
    for m in members:
        acc = _sum_into(acc, m)
    return _mean(acc, len(members), members[0])


def _shard_rows(x, pos, n_shards: int, mesh):
    """Shard ``pos``'s rows of the batch leaf ``x``: its block when ``x``
    is laid out on ``mesh`` by the batch spec, else its slice of dim 0."""
    if isinstance(x, ShardedTensor):
        spec = tuple(x.sharding.spec)
        if x.sharding.mesh is not mesh or spec[:1] != BATCH_SPEC or any(
                spec[1:]):
            raise ValueError(f"a laid-out batch leaf must be on the step's "
                             f"mesh by P({BATCH_SPEC[0]}), not {spec}")
        return x.shards[pos]
    b = x.shape[0]
    if b % n_shards:
        raise ValueError(f"batch dim {b} does not split over {n_shards} "
                         f"(pod, data) shards")
    i = pos[0] * mesh.devices.shape[1] + pos[1]
    return x[i * (b // n_shards):(i + 1) * (b // n_shards)]


def make_dp_train_step(loss_fn, mesh, ocfg: AdamWConfig,
                       compress_cross_pod: bool = True, stacked=None):
    """``loss_fn(params, batch) -> scalar``; ``mesh`` a ``launch.mesh.Mesh``
    with axes ``("pod", "data")``.  Returns ``train_step(params,
    opt_state, err_state, batch) -> (params, opt_state, err_state, loss,
    grad_norm)`` with the batch split over the shards on dim 0 (a tensor,
    or ``ShardedTensor`` leaves laid out by ``P(("pod", "data"))``) and
    params / optimizer state replicated: they live on the params' device
    and each shard reads them on its own.  ``stacked(name)``: the
    reference's stacked leaf a per-layer leaf is a slice of
    (``ModelApi.stacked_name``): the reference quantizes each stacked
    leaf as one tensor, with one scale over all its layers, and so does
    the port.  A model's params (``layers/<i>/...`` leaves) need it under
    compression, and the step raises without it; None suits only a tree
    without per-layer leaves."""
    if tuple(mesh.axis_names) != ("pod", "data"):
        raise ValueError(f"the data-parallel mesh has axes ('pod', "
                         f"'data'), not {mesh.axis_names}")
    n_pod, n_data = mesh.devices.shape

    def train_step(params, opt_state, err_state, batch):
        errs = (list(err_state) if isinstance(err_state, list)
                else [err_state] * n_pod)
        if compress_cross_pod and len(errs) != n_pod:
            raise ValueError(f"{len(errs)} residual trees for {n_pod} pods")
        home = flatten_with_names(params)[0][1].device
        replicas = {home: params}
        pod_grads, pod_loss = [], []
        for p in range(n_pod):
            acc, losses = None, []
            for d in range(n_data):
                dev = mesh.devices[p, d]
                if dev not in replicas:
                    replicas[dev] = map_with_names(
                        lambda _, t: t.to(dev), params)
                loss, g = loss_and_grads(loss_fn, replicas[dev], {
                    k: _shard_rows(v, (p, d), n_pod * n_data, mesh)
                    for k, v in batch.items()})
                losses.append(loss.detach().to(home))
                acc = _sum_into(acc, map_with_names(    # pmean over 'data'
                    lambda _, t: t.to(home), g))
                del g
            pod_grads.append(_mean(acc, n_data, params))
            pod_loss.append(pmean(losses))
            del acc
        del replicas
        if compress_cross_pod:
            grads, err_state = compressed_psum(pod_grads, errs, stacked)
        else:
            grads = pmean(pod_grads)
        del pod_grads
        model_dtype = flatten_with_names(params)[0][1].dtype
        new_params, new_opt, metrics = adamw_update(grads, opt_state, ocfg,
                                                    model_dtype)
        return (new_params, new_opt, err_state, pmean(pod_loss),
                metrics["grad_norm"])

    return train_step


def init_dp_state(params):
    """(AdamW state, zero residuals): the residual tree starts every pod."""
    return adamw_init(params), init_error_state(params)
