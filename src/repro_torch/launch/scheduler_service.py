"""Online scheduler service CLI: a JSONL decision loop on stdin/stdout
(the reference's ``python -m repro.launch.scheduler_service``).

Each input line is one JSON request; each response is one JSON line —
the shape a facility's submission portal scripts against.  Options come
from the shared grammar (``repro_torch.core.cliargs``): ``--policy
name:key=val,...``, ``--queue DISC:window=W``, ``--power-cap``, fault
probabilities.  Example session on the CPU (the default ``--device`` is
the CUDA card, and the service raises without one)::

    PYTHONPATH=src python -m repro_torch.launch.scheduler_service \
        --device cpu --queue easy_backfill:window=8 --power-cap 60000 \
        --checkpoint-dir /tmp/sched_ck <<'EOS'
    {"op": "submit", "prog": "BT", "arrival": 0.0}
    {"op": "submit", "prog": "LU", "arrival": 5.0}
    {"op": "drive", "until": 100.0}
    {"op": "whatif", "prog": "SP"}
    {"op": "checkpoint"}
    {"op": "drain"}
    {"op": "metrics"}
    {"op": "result"}
    EOS

Operations (all responses carry ``"ok"``; errors report ``"error"`` and
leave the session state untouched):

    submit   {"prog": name|index, "arrival"?: t, "k"?: f} -> {"job": id}
    drive    {"until": t} -> {"decisions": [...], "now": t'}
    drain    {} -> {"decisions": [...], "now": t'}   (open horizon)
    whatif   {"prog": ..., "arrival"?: t} -> projection (no state change)
    metrics  {} -> the streaming counters (``ServiceMetrics.snapshot``)
    checkpoint {} -> {"step": n}          (needs --checkpoint-dir)
    restore  {} -> {"resumed": bool}      (latest checkpoint)
    result   {} -> realized totals so far

``--restore`` resumes the latest checkpoint under ``--checkpoint-dir``
before reading any input: kill the process mid-stream, restart with
``--restore``, replay the remaining lines, and the decisions match the
uninterrupted session bit for bit.

``--pool N`` serves N sessions of the configuration through one
``SessionPool`` (one batched step for all of them).  A request carries
``{"session": i}`` to address session i; without it ``submit``,
``whatif`` and ``result`` go to session 0, while ``drive``, ``drain``,
``metrics``, ``checkpoint`` and ``restore`` fan out to every session and
key their answer by session.  ``--decision-log FILE`` appends every
placement as ``{"session": i, ...decision}`` through the pool's writer
thread; checkpoints go to ``s000``, ``s001``, ... under
``--checkpoint-dir``::

    PYTHONPATH=src python -m repro_torch.launch.scheduler_service \
        --device cpu --pool 4 --decision-log /tmp/decisions.jsonl <<'EOS'
    {"op": "submit", "session": 2, "prog": "BT", "arrival": 0.0}
    {"op": "drain"}
    {"op": "result", "session": 2}
    EOS
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np

from repro_torch.core import JSCC_SYSTEMS, Scheduler, make_npb_workload
from repro_torch.core.cliargs import (add_policy_options, build_fault,
                                      build_policy)
from repro_torch.service import Dispatcher, SessionPool, whatif


def _prog_index(w, prog):
    if isinstance(prog, str):
        if prog not in w.programs:
            raise ValueError(f"unknown program {prog!r}; "
                             f"catalog: {list(w.programs)}")
        return w.programs.index(prog)
    return int(prog)


def _scalar(v):
    """float(v) when v is scalar-like and finite, else None (strict-JSON
    safe: no Infinity/NaN literals on the wire)."""
    if np.ndim(v) != 0:
        return None
    f = float(v)
    return f if math.isfinite(f) else None


def _totals(r):
    totals = {k: _scalar(v) for k, v in r.to_dict(arrays=False).items()}
    return {"totals": {k: v for k, v in totals.items() if v is not None},
            "n_jobs": r.n_jobs}


def handle(disp, req: dict) -> dict:
    op = req.get("op")
    if op == "submit":
        j = disp.submit(_prog_index(disp.w, req["prog"]),
                        req.get("arrival"), req.get("k"))
        return {"ok": True, "job": j, "now": disp.now}
    if op in ("drive", "drain"):
        dec = (disp.drain() if op == "drain"
               else disp.drive(float(req["until"])))
        return {"ok": True, "decisions": dec, "now": disp.now}
    if op == "whatif":
        proj = whatif(disp, _prog_index(disp.w, req["prog"]),
                      req.get("arrival"), req.get("k"))
        proj["cap_headroom"] = _scalar(proj["cap_headroom"])
        return {"ok": True, **proj}
    if op == "metrics":
        return {"ok": True, "metrics": disp.metrics.snapshot()}
    if op == "checkpoint":
        return {"ok": True, "step": disp.save(blocking=True)}
    if op == "restore":
        return {"ok": True, "resumed": bool(disp.restore())}
    if op == "result":
        return {"ok": True, **_totals(disp.result())}
    return {"ok": False, "error": f"unknown op {op!r}"}


def handle_pool(pool, req: dict) -> dict:
    """The ``--pool N`` protocol: the ``{"session": i}`` envelope routes a
    request to one session; fan-out ops key their response by session
    index when the envelope is absent."""
    op = req.get("op")
    s = req.get("session")
    if s is not None:
        s = int(s)
        if not 0 <= s < pool.n:
            return {"ok": False,
                    "error": f"session {s} out of range (pool {pool.n})"}
    if op == "submit":
        i = s or 0
        j = pool.submit(i, _prog_index(pool.w, req["prog"]),
                        req.get("arrival"), req.get("k"))
        return {"ok": True, "session": i, "job": j, "now": pool.now(i)}
    if op in ("drive", "drain"):
        until = None if op == "drain" else float(req["until"])
        if s is None:
            dec = pool.drain() if until is None else pool.drive(until)
            return {"ok": True,
                    "decisions": {str(i): d for i, d in dec.items()},
                    "now": {str(i): pool.now(i) for i in range(pool.n)}}
        dec = (pool.drain(session=s) if until is None
               else pool.drive(until, session=s))
        return {"ok": True, "session": s, "decisions": dec,
                "now": pool.now(s)}
    if op == "whatif":
        i = s or 0
        proj = pool.whatif(i, _prog_index(pool.w, req["prog"]),
                           req.get("arrival"), req.get("k"))
        proj["cap_headroom"] = _scalar(proj["cap_headroom"])
        return {"ok": True, "session": i, **proj}
    if op == "metrics":
        if s is None:
            return {"ok": True,
                    "metrics": {str(i): pool.metrics(i)
                                for i in range(pool.n)}}
        return {"ok": True, "session": s, "metrics": pool.metrics(s)}
    if op == "checkpoint":
        if s is None:
            return {"ok": True, "steps": pool.save()}
        return {"ok": True, "session": s, "step": pool.save(session=s)}
    if op == "restore":
        if s is None:
            return {"ok": True, "resumed": bool(pool.restore())}
        return {"ok": True, "session": s,
                "resumed": bool(pool.restore(session=s))}
    if op == "result":
        i = s or 0
        return {"ok": True, "session": i, **_totals(pool.result(i))}
    return {"ok": False, "error": f"unknown op {op!r}"}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="online scheduler service (JSONL loop)")
    add_policy_options(ap)                  # the shared grammar (cliargs)
    ap.add_argument("--capacity", type=int, default=256,
                    help="max jobs per session (fixed tensor shapes)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warm-start", action="store_true",
                    help="profile tables pre-filled with ground truth")
    ap.add_argument("--pool", type=int, default=0, metavar="N",
                    help="serve N sessions through one batched step "
                         "(0 = one classic session)")
    ap.add_argument("--decision-log", default="", metavar="FILE",
                    help="pool mode: append every placement decision as "
                         "a JSONL record through the writer thread")
    ap.add_argument("--checkpoint-dir", default="",
                    help="arm checkpoint/restore under this directory")
    ap.add_argument("--restore", action="store_true",
                    help="resume the latest checkpoint before reading input")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    w = make_npb_workload(JSCC_SYSTEMS)
    sched = Scheduler(build_policy(args), faults=build_fault(args),
                      seeds=args.seed, warm_start=args.warm_start,
                      device=args.device)
    if args.pool:
        pool = SessionPool.replicate(
            sched, args.pool, w, capacity=args.capacity,
            checkpoint_dir=args.checkpoint_dir or None,
            decision_log=args.decision_log or None)
        if args.restore:
            resumed = pool.restore()
            print(json.dumps({
                "ok": True, "resumed": bool(resumed), "sessions": pool.n,
                "n_submitted": [d.n_submitted for d in pool.sessions],
                "now": [pool.now(i) for i in range(pool.n)]}), flush=True)
        dispatch, target = handle_pool, pool
    else:
        disp = Dispatcher.from_scheduler(
            sched, w, capacity=args.capacity,
            checkpoint_dir=args.checkpoint_dir or None)
        if args.restore:
            resumed = disp.restore()
            print(json.dumps({"ok": True, "resumed": bool(resumed),
                              "n_submitted": disp.n_submitted,
                              "now": disp.now}), flush=True)
        dispatch, target = handle, disp

    try:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                resp = dispatch(target, json.loads(line))
            except Exception as e:                  # state stays intact
                resp = {"ok": False, "error": str(e)}
            print(json.dumps(resp), flush=True)
    finally:
        if args.pool:
            pool.close()


if __name__ == "__main__":
    main()
