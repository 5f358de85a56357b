"""The system under test as the benchmark drives it: the port's front end
(the NPB stream builder, the SWF loader and its class binning), its
``Scheduler`` facade and the kth_free launch counter.  The only module of
the benchmark that imports the port."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import (JSCC_BY_NAME, FaultConfig, Scheduler,
                              make_npb_workload, make_policy)
from repro_torch.data import load_swf, workload_from_trace
from repro_torch.kernels import _build
from repro_torch.kernels.kth_free import kth_free_cuda

#: the campaign totals compared with the reference, per lane
FIELDS = ("total_energy", "total_wait", "slowdown_sum", "makespan",
          "max_wait", "busy", "idle_energy", "C_tab", "T_tab", "runs",
          "n_backfilled")


def build_workload(traffic: dict, config: dict):
    """The stream's ``Workload``, built by the port's front end: the NPB
    tables from the program names and arrivals, or the SWF text parsed and
    binned into classes."""
    systems = [JSCC_BY_NAME[name] for name in config["systems"]]
    if traffic["kind"] == "npb_stream":
        return make_npb_workload(systems, order=traffic["order"],
                                 arrivals=traffic["arrival"])
    return workload_from_trace(load_swf(traffic["lines"]), systems)


def prefix(w, n: int):
    """The first ``n`` jobs of a stream."""
    return dataclasses.replace(w, prog=w.prog[:n], arrival=w.arrival[:n],
                               k_job=w.k_job[:n])


def scheduler(config: dict, seeds, device) -> Scheduler:
    """The campaign of ``config`` over lane seeds ``seeds``: the policy's K
    grid x seeds, one fault model, totals only."""
    pol = make_policy(config["policy"],
                      k=np.asarray(config["k_grid"], np.float32))
    return Scheduler(pol, seeds=tuple(int(s) for s in seeds),
                     faults=FaultConfig(**config["faults"]),
                     warm_start=bool(config["warm_start"]),
                     queue=config["queue"],
                     easy_eval=config.get("easy_eval", "batched"),
                     device=device)


def run(sched: Scheduler, w, config: dict) -> dict:
    """One campaign: the result fields, lanes flattened to [B, ...] in
    (K, seed) order."""
    res = sched.run(w, totals_only=bool(config["totals_only"]))
    lead = len(res.axes)
    return {f: getattr(res, f).flatten(0, lead - 1) for f in FIELDS}


def build_kernels() -> None:
    """Load the kth_free library, compiling it first where the checkout
    has none (``build/torch_kernels/``)."""
    _build.load("kth_free")


def kth_launches() -> int:
    """kth_free kernel launches made by this process so far."""
    return kth_free_cuda.launches


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
