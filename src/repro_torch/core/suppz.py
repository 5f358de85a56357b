"""SUPPZ-style job-submission front end (paper §Implementation) on the
port's selection rule.

It mirrors the paper's integration of the algorithm into SUPPZ's
``mpirun``:

- the submitted executable is identified by its hash (the paper stores
  the hash of the binary as the program's unique id);
- the hash, the submission arguments and the measured (C, T) history
  live in a small on-disk msgpack database, laid out as the reference's
  (``repro/core/suppz.py``), so either front end reads the other's file;
- if the user names a resource type, the front end only notifies (returns
  the recommendation); otherwise the job is auto-queued on the selected
  system;
- K comes from the administrator, or automatically from the ordered time,
  K = T_max / T (``profiles.k_auto``, as an allowed-increase fraction).

The selection runs ``algorithm.select_system("paper", ...)`` on float32
tensors on ``device`` (None = CUDA, ``RuntimeError`` without one; "cpu"
runs on the CPU).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import msgpack
import numpy as np
import torch

from repro_torch.core.algorithm import select_system
from repro_torch.core.profiles import k_auto
from repro_torch.device import resolve_device
from repro_torch.utils import prng


def program_id(executable_bytes: bytes) -> str:
    """The paper's unique program identifier: hash of the executable."""
    return hashlib.sha256(executable_bytes).hexdigest()[:16]


@dataclass
class Submission:
    executable: bytes           # or its contents; hashed for identity
    np_: int                    # processors requested ('np' in mpirun)
    t_max: float                # ordered occupancy time (seconds)
    resource_type: str | None = None   # user-pinned system (notify-only mode)
    k: float | None = None      # admin K (fraction); None => auto


@dataclass
class Decision:
    program: str
    system: str
    auto_queued: bool           # False => notification only (user pinned type)
    k_used: float
    explored: bool              # placement was an exploration run


class SuppzFrontend:
    """Persistent front end over a set of systems (names fixed at init)."""

    def __init__(self, db_path: str, system_names, device=None):
        self.db_path = db_path
        self.systems = list(system_names)
        self.device = resolve_device(device)
        # pid -> {"C": {}, "T": {}, "runs": {}, "submits": []}
        self.db = {"programs": {}}
        if os.path.exists(db_path):
            with open(db_path, "rb") as f:
                self.db = msgpack.unpackb(f.read())

    def _save(self):
        tmp = self.db_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(self.db))
        os.replace(tmp, self.db_path)

    def _entry(self, pid: str):
        return self.db["programs"].setdefault(
            pid, {"C": {}, "T": {}, "runs": {}, "submits": []})

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # ------------------------------------------------------------- submit
    def submit(self, sub: Submission, availability=None) -> Decision:
        pid = program_id(sub.executable)
        ent = self._entry(pid)
        ent["submits"].append({"np": sub.np_, "t_max": sub.t_max,
                               "type": sub.resource_type})

        c_row = np.array([ent["C"].get(s, 0.0) for s in self.systems])
        t_row = np.array([ent["T"].get(s, 0.0) for s in self.systems])
        runs = np.array([ent["runs"].get(s, 0) for s in self.systems])
        avail = (np.zeros(len(self.systems)) if availability is None
                 else np.asarray(availability, float))

        # K: admin-specified, else auto from ordered time vs best history
        if sub.k is not None:
            k = sub.k
        else:
            t_hist = t_row[runs > 0].min() if (runs > 0).any() else 0.0
            k = k_auto(sub.t_max, t_hist)

        idx = int(select_system(
            "paper", c_row=self._tensor(c_row), t_row=self._tensor(t_row),
            runs_row=self._tensor(runs, torch.int32),
            avail_row=self._tensor(avail), k=self._tensor(k),
            c_pred_row=self._tensor(c_row), t_pred_row=self._tensor(t_row),
            key=prng.key(len(ent["submits"]), self.device)))

        self._save()
        return Decision(program=pid, system=self.systems[idx],
                        auto_queued=sub.resource_type is None,
                        k_used=k, explored=bool((runs == 0).any()))

    # ---------------------------------------------------------- complete
    def report_completion(self, executable: bytes, system: str,
                          c: float, t: float):
        """Store the measured profile after successful completion (running
        average over repeats, as ProfileStore does)."""
        pid = program_id(executable)
        ent = self._entry(pid)
        n = ent["runs"].get(system, 0)
        ent["C"][system] = (ent["C"].get(system, 0.0) * n + c) / (n + 1)
        ent["T"][system] = (ent["T"].get(system, 0.0) * n + t) / (n + 1)
        ent["runs"][system] = n + 1
        self._save()
