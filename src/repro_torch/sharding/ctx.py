"""Logical-axis sharding rules, decoupled from model code
(``repro/sharding/ctx.py``).

A launcher installs a rule set mapping logical axis names to mesh axes
with ``use_rules``; ``spec_for`` turns logical names into a
``PartitionSpec``.  The port runs in one process and places no weight by
its spec, so a layout constraint never moves a value: ``annotate``
returns its input, with or without rules.  The rules still decide one
numeric feature: the MoE dispatch buckets tokens per data shard, and
``dispatch_shards`` says how many there are (``models/moe.py``).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass

_state = threading.local()


def _canon(part):
    """A spec entry as the reference's ``PartitionSpec`` keeps it: None, an
    axis name, or a tuple of two or more names (a one-name sequence is
    the name, an empty one None)."""
    if part is None or isinstance(part, str):
        return part
    part = tuple(part)
    if not part:
        return None
    return part[0] if len(part) == 1 else part


class PartitionSpec(tuple):
    """Where each dim of an array lives on a mesh: per dim None
    (replicated), a mesh axis name, or a tuple of names (the dim split
    over their product, row-major).  ``tuple(spec)`` equals the
    reference's ``tuple(jax.sharding.PartitionSpec(...))`` part for
    part."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_canon(p) for p in parts))

    def __eq__(self, other):
        if isinstance(other, tuple):
            return tuple(self) == tuple(_canon(p) for p in other)
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = tuple.__hash__

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: PartitionSpec


def current_rules():
    return getattr(_state, "rules", None), getattr(_state, "mesh", None)


@contextmanager
def use_rules(mesh, rules: dict):
    """rules: {logical_name: mesh_axis | tuple | None}, installed for this
    thread inside the ``with``."""
    old = current_rules()
    _state.rules, _state.mesh = rules, mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = old


def spec_for(logical_axes, rules) -> PartitionSpec:
    return PartitionSpec(*(None if name is None else rules.get(name)
                           for name in logical_axes))


def annotate(x, logical_axes):
    """The reference's sharding constraint: a layout hint that never
    changes a value; the port places nothing by it and returns ``x``."""
    return x


# Default logical -> mesh-axis rule sets -----------------------------------

def lm_rules(multi_pod: bool, fsdp: bool = False) -> dict:
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch_axes,
        "seq_shard": batch_axes,    # sequence-sharded KV caches (long decode)
        "heads": "model",
        "kv_heads": "model",
        "vocab": "model",
        "ff": "model",
        "experts": "model",
        "embed": ("data" if fsdp else None),
        "seq_sp": "model",          # sequence-parallel residual stream
        # MoE dispatch locality: tokens are sorted and capacity-bucketed
        # PER data shard (GShard-style).  32 = pod x data on the
        # multi-pod mesh.
        "dp_shards": 32 if multi_pod else 16,
    }


def dispatch_shards() -> int:
    """Number of data shards for MoE-local dispatch (1 when no rules)."""
    rules, _ = current_rules()
    if not rules:
        return 1
    return int(rules.get("dp_shards", 1))
