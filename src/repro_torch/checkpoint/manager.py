"""Fault-tolerant checkpointing of trees of tensors, in the reference's
on-disk format (``src/repro/checkpoint/manager.py``).

Guarantees:
  - ATOMIC: a checkpoint directory appears only when complete (tmp dir +
    os.replace); a crash mid-save never corrupts the latest checkpoint.
  - ASYNC: saves run on a background thread; ``wait()`` joins before exit.
    Every tensor is copied to host memory before ``save`` returns, so the
    caller may go on changing its tensors in place.
  - RESTORE onto the template: each leaf comes back on the template
    leaf's device and dtype (a tensor template gives tensors, a numpy
    template arrays).
  - GC: keeps the most recent ``keep_n`` checkpoints.

Format: one ``arrays.npz`` (flat name -> ndarray, ``/`` written as
``|``) + ``manifest.msgpack`` (step, names, shapes, dtypes, user
metadata), so either package restores the other's checkpoints of the
same tree.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

import msgpack
import numpy as np
import torch

from repro_torch.utils.tree import flatten_with_names, map_with_names

_STEP_DIR = re.compile(r"^step_(\d+)$")


def _host_copy(x) -> np.ndarray:
    """A numpy copy of a leaf that later in-place writes cannot reach."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _tree_to_flat(tree):
    flat = flatten_with_names(tree)
    names = [n for n, _ in flat]
    arrays = {n: _host_copy(x) for n, x in flat}
    return names, arrays


def _like(a: np.ndarray, t):
    """The restored array ``a`` as the template leaf ``t`` holds it."""
    if isinstance(t, torch.Tensor):
        return torch.from_numpy(np.array(a, order="C")).to(
            device=t.device, dtype=t.dtype)
    return a.astype(np.asarray(t).dtype)


class CheckpointManager:
    """``namespace`` scopes a manager to a subdirectory of ``directory``
    (one per session when several share a ``--checkpoint-dir`` root)."""

    def __init__(self, directory: str, keep_n: int = 3,
                 namespace: str | None = None):
        if namespace is not None:
            if os.sep in namespace or namespace.startswith("."):
                raise ValueError(f"bad checkpoint namespace {namespace!r}")
            directory = os.path.join(directory, namespace)
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, metadata: dict | None = None,
             blocking: bool = False):
        names, arrays = _tree_to_flat(tree)
        manifest = {
            "step": int(step),
            "names": names,
            "shapes": {n: list(arrays[n].shape) for n in names},
            "dtypes": {n: str(arrays[n].dtype) for n in names},
            "metadata": metadata or {},
        }

        def _write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{n.replace("/", "|"): a for n, a in arrays.items()})
            with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
                f.write(msgpack.packb(manifest))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)          # atomic publish
            self._gc()
            return final

        with self._lock:
            self.wait()
            if blocking:
                return _write()
            self._pending = self._pool.submit(_write)
            return None

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_DIR.match(name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.msgpack")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None):
        """template: a tree of tensors or arrays giving the structure, and
        each leaf's device and dtype.  Returns (tree, step, metadata) or
        (None, None, None) if there is no checkpoint."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None, None
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
            manifest = msgpack.unpackb(f.read())
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            by_name = {n: npz[n.replace("/", "|")]
                       for n in manifest["names"]}

        def leaf(name, t):
            if name not in by_name:
                raise KeyError(f"checkpoint {path} missing tensor {name!r}")
            a = by_name[name]
            want = tuple(t.shape)
            if tuple(a.shape) != want:
                raise ValueError(
                    f"{name}: checkpoint shape {a.shape} != template {want}")
            return _like(a, t)

        return map_with_names(leaf, template), manifest["step"], \
            manifest["metadata"]
