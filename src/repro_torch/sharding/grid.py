"""Campaign-grid sharding primitives (``repro/sharding/grid.py``).

The reference spreads a campaign's flat (fault x policy x seed) batch axis
over a 1-D ``("grid",)`` mesh with ``shard_map``.  The port runs in one
process: ``engine._lane_split`` plays ``shard_map``'s part, splitting the
lanes over ``launch.mesh.make_grid_devices`` and running each slice on its
device.  Per-lane simulations never communicate, so the split is a pure
partition, bit-identical to the one-device run.  These are the specs that
name the layout.
"""

from __future__ import annotations

from repro_torch.sharding.ctx import PartitionSpec

#: the campaign mesh's one axis name
GRID_AXIS = "grid"

#: spec for leaves sharded along the flat batch axis (leading dim)
grid_spec = PartitionSpec(GRID_AXIS)

#: spec for leaves replicated to every device (workload arrays, xs chunks)
replicated = PartitionSpec()
