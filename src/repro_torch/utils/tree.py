"""Nested containers of tensors: leaves with path names, and rebuilding.

A tree is any nesting of dicts, lists, tuples and ``NamedTuple``s; every
other object (a tensor, a numpy array, a number, a tuple subclass such as
a ``PartitionSpec``, as in JAX's pytrees) is a leaf and ``None``
is an empty subtree.  Names follow the reference's pytree paths
(``src/repro/utils/tree.py``): a dict key gives ``str(key)`` (keys in
sorted order), a sequence its index and a ``NamedTuple`` its field name,
joined with ``/``.  So a checkpoint of a tree names its tensors as the
reference's checkpoints do.
"""

from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(name, child) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if type(tree) in (list, tuple):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def flatten_with_names(tree, prefix: str = "") -> list:
    """Return [(path_str, leaf)] for all leaves, in the reference's
    order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, child in kids:
        out += flatten_with_names(child, f"{prefix}/{name}" if prefix
                                  else name)
    return out


def map_with_names(fn, tree, prefix: str = ""):
    """Rebuild ``tree`` with every leaf replaced by ``fn(path_str,
    leaf)``; containers keep their type (and a dict its key order)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    join = (lambda n: f"{prefix}/{n}") if prefix else (lambda n: n)
    if isinstance(tree, dict):
        return {k: map_with_names(fn, tree[k], join(str(k))) for k in tree}
    new = [map_with_names(fn, child, join(name)) for name, child in kids]
    if _is_namedtuple(tree):
        return type(tree)(*new)
    return type(tree)(new)
