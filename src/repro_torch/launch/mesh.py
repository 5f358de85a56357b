"""The devices a sharded campaign spreads its lanes over.

A function, not a module-level constant: importing this module never
touches device state (the device count is read at call time).  The
production and elastic meshes of the reference's ``launch/mesh.py`` come
with the LM-side stack (ROADMAP Queue 1 item 14f).
"""

from __future__ import annotations

import torch


def make_grid_devices(shards="auto", device=None) -> list:
    """The devices of ``Scheduler(shards=...)``, the counterpart of the
    reference's ``make_grid_mesh``: the flat (fault x policy x seed) lanes
    of a campaign split over them.  ``shards``: "auto" / None = every
    local device, or a count in 1..local devices.  The local devices are
    the CUDA devices, or the CPU alone when ``device`` is a CPU device."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        local = [torch.device("cpu")]
    else:
        local = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    n_local = len(local)
    n = n_local if shards in (None, "auto") else int(shards)
    if not 1 <= n <= n_local:
        raise ValueError(f"shards={shards!r} not in 1..{n_local} "
                         f"(local devices)")
    return local[:n]
