"""Arrays laid out on a mesh: each shard's block on its shard's device.

``put(x, sharding)`` is the reference's ``jax.make_array_from_callback(
x.shape, sharding, lambda idx: x[idx])``: the shard at each mesh position
gets the block of ``x`` its ``PartitionSpec`` gives it (a dim split over
mesh axes in row-major order of their coordinates, replicated over the
axes the spec does not name).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.sharding.ctx import NamedSharding


def _axes(part) -> tuple:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def block_index(shape, sharding: NamedSharding, position) -> tuple:
    """The slices of an array of ``shape`` held at mesh ``position`` (an
    index into ``sharding.mesh.devices``)."""
    mesh = sharding.mesh
    coord = dict(zip(mesh.axis_names, position))
    size = dict(zip(mesh.axis_names, mesh.devices.shape))
    spec = tuple(sharding.spec) + (None,) * (len(shape) - len(sharding.spec))
    out = []
    for dim, part in zip(shape, spec):
        n, k = 1, 0
        for a in _axes(part):
            n, k = n * size[a], k * size[a] + coord[a]
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"over {part} ({n} shards)")
        out.append(slice(k * (dim // n), (k + 1) * (dim // n)))
    return tuple(out)


@dataclass(frozen=True, eq=False)
class ShardedTensor:
    """A global array of ``shape``: ``shards`` (an object array shaped like
    the mesh) holds each position's block on its device."""
    shape: tuple
    sharding: NamedSharding
    shards: np.ndarray


def put(x: np.ndarray, sharding: NamedSharding) -> ShardedTensor:
    """``x`` laid out by ``sharding``: each block a tensor with ``x``'s
    dtype on its shard's device."""
    devices = sharding.mesh.devices
    shards = np.empty(devices.shape, dtype=object)
    for pos in np.ndindex(devices.shape):
        block = np.ascontiguousarray(x[block_index(x.shape, sharding, pos)])
        shards[pos] = torch.from_numpy(block).to(devices[pos])
    return ShardedTensor(tuple(x.shape), sharding, shards)
