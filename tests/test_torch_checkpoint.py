"""Port parity: ``repro_torch.checkpoint`` and ``repro_torch.utils.tree``
against the reference's ``repro.checkpoint.manager`` and
``repro.utils.tree``.

The on-disk format is the reference's (``arrays.npz`` with ``/`` written
as ``|``, ``manifest.msgpack``), so a tree saved by either package
restores in the other; names follow the reference's pytree paths.
"""

import os
from typing import NamedTuple

import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as RManager  # noqa: E402
from repro.utils.tree import flatten_with_names as r_flatten  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.utils.tree import (flatten_with_names,  # noqa: E402
                                    map_with_names)
from _jax_caches import release_compiled  # noqa: E402,F401


class Carry(NamedTuple):
    node_free: object
    acc: tuple
    now: object


def _tree():
    """A nested tree as the dispatcher saves one: a NamedTuple with an
    empty tuple, dicts with unsorted keys, a list, bools and ints."""
    g = np.random.default_rng(0)
    return {
        "carry": Carry(g.random((1, 4, 6), dtype=np.float32), (),
                       np.float32([3.5])),
        "jobs": {"prog": np.arange(5, dtype=np.int64),
                 "arrival": g.random(5, dtype=np.float32),
                 "k_job": np.full(5, np.nan, np.float32)},
        "perjob": [np.zeros((1, 6), bool), np.ones(3, np.int32)],
        "b": {"z": np.float32(1.0), "a": np.arange(2, dtype=np.float32)},
    }


def _torch_tree(tree):
    return map_with_names(lambda _, x: torch.as_tensor(np.asarray(x)), tree)


def _equal(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


def test_names_equal_the_reference():
    """``flatten_with_names`` gives the reference's paths in its order,
    for numpy and torch leaves alike, and ``map_with_names`` rebuilds the
    containers."""
    tree = _tree()
    want = [name for name, _ in r_flatten(tree)]
    assert [name for name, _ in flatten_with_names(tree)] == want
    tt = _torch_tree(tree)
    assert [name for name, _ in flatten_with_names(tt)] == want
    assert isinstance(tt["carry"], Carry) and tt["carry"].acc == ()
    assert isinstance(tt["perjob"], list)
    assert flatten_with_names(None) == [] and flatten_with_names(()) == []


def test_save_restore_roundtrip_on_the_template_device(tmp_path):
    tree = _torch_tree(_tree())
    m = CheckpointManager(str(tmp_path))
    m.save(0, tree, metadata={"n": 3, "d": [{"job": 1}]}, blocking=True)
    got, step, meta = m.restore(tree)
    assert step == 0 and meta == {"n": 3, "d": [{"job": 1}]}
    for (name, a), (_, b) in zip(flatten_with_names(tree),
                                 flatten_with_names(got)):
        assert isinstance(b, torch.Tensor) and b.dtype == a.dtype, name
        assert _equal(a, b), name
    assert isinstance(got["carry"], Carry)


def test_save_copies_before_returning(tmp_path):
    """A background save writes the tensors as they were at ``save``,
    whatever the caller writes in place afterwards."""
    x = torch.zeros(1000)
    m = CheckpointManager(str(tmp_path))
    m.save(0, {"x": x})
    x.fill_(7.0)
    m.wait()
    got, _, _ = m.restore({"x": x})
    assert float(got["x"].abs().max()) == 0.0


def test_atomic_publish_and_keep_n(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_n=2)
    tree = {"a": torch.arange(4)}
    os.makedirs(tmp_path / ".tmp_step_9")          # a crashed save
    (tmp_path / "step_8").mkdir()                   # no manifest: not a step
    for s in range(4):
        m.save(s, tree)
    m.wait()
    assert m.all_steps() == [2, 3] and m.latest_step() == 3
    names = sorted(os.listdir(tmp_path))
    assert "step_0" not in names and "step_1" not in names
    assert not any(n.startswith(".tmp_step_") and n != ".tmp_step_9"
                   for n in names)
    with open(tmp_path / "step_3" / "manifest.msgpack", "rb") as f:
        man = msgpack.unpackb(f.read())
    assert man["names"] == ["a"] and man["dtypes"] == {"a": "int64"}
    assert man["shapes"] == {"a": [4]} and man["step"] == 3


@pytest.mark.parametrize("ns", ["../x", ".hidden", "a" + os.sep + "b"])
def test_bad_namespace_rejected(tmp_path, ns):
    with pytest.raises(ValueError, match="namespace"):
        CheckpointManager(str(tmp_path), namespace=ns)
    with pytest.raises(ValueError, match="namespace"):
        RManager(str(tmp_path), namespace=ns)


def test_namespace_subdirectory(tmp_path):
    m = CheckpointManager(str(tmp_path), namespace="s000")
    m.save(0, {"a": torch.ones(2)}, blocking=True)
    assert (tmp_path / "s000" / "step_0" / "arrays.npz").exists()


def test_shape_mismatch_and_missing_name_raise(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(0, {"a": torch.ones(3)}, blocking=True)
    with pytest.raises(ValueError, match="shape"):
        m.restore({"a": torch.ones(4)})
    with pytest.raises(KeyError, match="missing"):
        m.restore({"b": torch.ones(3)})
    assert CheckpointManager(str(tmp_path / "empty")).restore(
        {"a": torch.ones(3)}) == (None, None, None)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _tree()
    RManager(str(tmp_path)).save(5, tree, metadata={"k": 1}, blocking=True)
    got, step, meta = CheckpointManager(str(tmp_path)).restore(
        _torch_tree(tree))
    assert step == 5 and meta == {"k": 1}
    for (name, a), (_, b) in zip(flatten_with_names(tree),
                                 flatten_with_names(got)):
        assert _equal(a, b.numpy()), name


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _tree()
    CheckpointManager(str(tmp_path)).save(2, _torch_tree(tree),
                                          metadata={"k": [1, 2]},
                                          blocking=True)
    got, step, meta = RManager(str(tmp_path)).restore(tree)
    assert step == 2 and meta == {"k": [1, 2]}
    for (name, a), (_, b) in zip(r_flatten(tree), r_flatten(got)):
        assert _equal(a, b), name
    # a numpy template restores numpy arrays in the port too
    back, _, _ = CheckpointManager(str(tmp_path)).restore(tree)
    assert isinstance(back["jobs"]["prog"], np.ndarray)
    assert _equal(back["jobs"]["k_job"], tree["jobs"]["k_job"])
