"""Meshes: the devices a sharded campaign spreads its lanes over, and the
production, elastic and data-parallel meshes of the LM stack
(``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module never
touches device state (the device count is read at call time).

The port runs in one process.  A ``Mesh`` is an array of shards with axis
names; each shard is placed on a local device, round robin over the CUDA
devices (``torch.cuda.device_count()``), or on the CPU when asked for.
On one card every shard is on ``cuda:0`` and the shards run one after
another from the calling thread, as ``engine._lane_split`` runs campaign
lanes.  The spec functions read ``mesh.axis_names`` and
``mesh.devices.shape``, as the reference's do.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: a numpy object array of ``torch.device`` whose shape is
    the mesh's, one axis per name of ``axis_names``."""
    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _local_devices(device=None) -> list:
    """The CUDA devices (None: CUDA, raising without a card), or the CPU
    alone when ``device`` is a CPU device."""
    device = resolve_device(device)
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _make_mesh(shape, axes, device=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``, its shards placed
    round robin over the local devices in row-major order."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"rank")
    local = _local_devices(device)
    flat = np.empty(int(np.prod(shape)), dtype=object)
    for i in range(flat.size):
        flat[i] = local[i % len(local)]
    return Mesh(flat.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """Single pod: (data=16, model=16), 256 shards.  Multi-pod: (pod=2,
    data=16, model=16), 512 shards; the 'pod' axis carries only data
    parallelism (hierarchical gradient reduction)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_elastic_mesh(n_devices: int, model_parallel: int = 16,
                      device=None) -> Mesh:
    """Rebuild a (data, model) mesh from however many shards survive (the
    elastic-restart path: the data dim shrinks, the model dim is kept so
    checkpoints reshard without repartitioning logic)."""
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices do not split into "
                         f"model_parallel={model_parallel}")
    return _make_mesh((n_devices // model_parallel, model_parallel),
                      ("data", "model"), device)


def make_grid_devices(shards="auto", device=None) -> list:
    """The devices of ``Scheduler(shards=...)``, the counterpart of the
    reference's ``make_grid_mesh``: the flat (fault x policy x seed) lanes
    of a campaign split over them.  ``shards``: "auto" / None = every
    local device, or a count in 1..local devices.  The local devices are
    ``_local_devices(device)``."""
    local = _local_devices(device)
    n_local = len(local)
    n = n_local if shards in (None, "auto") else int(shards)
    if not 1 <= n <= n_local:
        raise ValueError(f"shards={shards!r} not in 1..{n_local} "
                         f"(local devices)")
    return local[:n]
