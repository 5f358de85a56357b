"""Port parity: the service CLI (``repro_torch.launch.scheduler_service``)
against the reference's ``repro.launch.scheduler_service``.

In process, the two ``handle`` loops answer the same request stream with
the same responses, apart from the wall-clock latency counters (and the
sums over jobs of ``result``, held to the port's rtol 1e-6 band).  One
subprocess test (``slow``) kills a session after a checkpoint, resumes
it with ``--restore`` and finishes it: its decisions and totals equal an
uninterrupted session's.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro.launch.scheduler_service as r_cli  # noqa: E402
from repro.core import JSCC_SYSTEMS as R_SYSTEMS  # noqa: E402
from repro.core import Scheduler as RScheduler  # noqa: E402
from repro.core import cliargs as r_args  # noqa: E402
from repro.core import make_npb_workload as r_npb  # noqa: E402
from repro.service import Dispatcher as RDispatcher  # noqa: E402
from repro_torch.core import JSCC_SYSTEMS, Scheduler  # noqa: E402
from repro_torch.core import cliargs as t_args  # noqa: E402
from repro_torch.core import make_npb_workload  # noqa: E402
from repro_torch.launch import scheduler_service as t_cli  # noqa: E402
from repro_torch.service import Dispatcher  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARGV = ["--queue", "easy_backfill:window=4", "--warm-start", "--capacity",
        "16"]
#: an empty session's answers, then the reference CLI docstring's
#: session (scheduler_service.py:9-19), then errors, a past submission
#: and a restore
EMPTY = [{"op": "result"}, {"op": "drain"}, {"op": "metrics"}]
DOC = [{"op": "submit", "prog": "BT", "arrival": 0.0},
       {"op": "submit", "prog": "LU", "arrival": 5.0},
       {"op": "drive", "until": 100.0},
       {"op": "whatif", "prog": "SP"},
       {"op": "checkpoint"},
       {"op": "drain"},
       {"op": "metrics"},
       {"op": "result"}]
MORE = [{"op": "submit", "prog": "nope"},
        {"op": "submit", "prog": 2, "arrival": 1.0},
        {"op": "bogus"},
        {"op": "submit", "prog": "EP", "k": 0.3},
        {"op": "whatif", "prog": 4, "arrival": 900.0},
        {"op": "drive", "until": 2000.0},
        {"op": "restore"},
        {"op": "drain"},
        {"op": "metrics"},
        {"op": "result"}]
LATENCY = ("latency_us_last", "latency_us_total", "latency_us_max",
           "mean_latency_us")
REDUCED = ("total_energy", "total_wait", "slowdown_sum", "mean_wait",
           "mean_slowdown")


def _sessions(argv, ck):
    """The reference's and the port's sessions, built as each ``main``
    builds its one session."""
    out = []
    for args_mod, sched, npb, systems, disp, extra in (
            (r_args, RScheduler, r_npb, R_SYSTEMS, RDispatcher, {}),
            (t_args, Scheduler, make_npb_workload, JSCC_SYSTEMS, Dispatcher,
             {"device": "cpu"})):
        ap = argparse.ArgumentParser()
        args_mod.add_policy_options(ap)
        args = ap.parse_known_args(argv)[0]
        s = sched(args_mod.build_policy(args),
                  faults=args_mod.build_fault(args), seeds=0,
                  warm_start=True, **extra)
        out.append(disp.from_scheduler(s, npb(systems), capacity=16,
                                       checkpoint_dir=str(ck / disp.__module__)))
    return out


def _same(want, got, path="resp"):
    """Equal JSON values, but the latency counters (not compared) and the
    sums over jobs (rtol 1e-6)."""
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            if k in LATENCY:
                continue
            if k in REDUCED and isinstance(want[k], float):
                assert got[k] == pytest.approx(want[k], rel=1e-6), path + k
            else:
                _same(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            _same(a, b, f"{path}[{i}]")
    else:
        assert want == got and type(want) is type(got), (path, want, got)


@pytest.mark.parametrize("argv", [ARGV, ["--queue", "conservative:window=4",
                                         "--power-cap", "60000",
                                         "--failures", "0.3"]])
def test_handle_matches_the_reference(tmp_path, argv):
    """The docstring's stream and the error paths: every response equals
    the reference's (JSON round trip included), latency aside."""
    ref, port = _sessions(argv, tmp_path)
    for req in EMPTY + DOC + MORE:
        resp = []
        for handle, d in ((r_cli.handle, ref), (t_cli.handle, port)):
            try:
                r = handle(d, req)
            except Exception as e:          # as main() reports it
                r = {"ok": False, "error": str(e)}
            resp.append(json.loads(json.dumps(r)))
        _same(resp[0], resp[1], f"{req}")
    # the restore went back to the checkpoint after two submissions
    assert port.metrics.n_submitted == port.n_submitted == 2


def run_cli(lines, *extra):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.scheduler_service",
         "--device", "cpu", *ARGV, *extra],
        input="\n".join(json.dumps(x) for x in lines), capture_output=True,
        text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return [json.loads(line) for line in proc.stdout.splitlines() if line]


STREAM = [{"op": "submit", "prog": "BT", "arrival": 0.0},
          {"op": "submit", "prog": "LU", "arrival": 30.0},
          {"op": "submit", "prog": "SP", "arrival": 60.0},
          {"op": "submit", "prog": "EP", "arrival": 90.0}]


@pytest.mark.slow
def test_kill_and_restore_matches_uninterrupted(tmp_path):
    """Checkpoint mid-stream, die, ``--restore`` in a new process, finish:
    the union of decisions and the totals equal one uninterrupted
    session's."""
    ck = ["--checkpoint-dir", str(tmp_path)]
    head, tail = STREAM[:2], STREAM[2:]
    finish = [{"op": "drain"}, {"op": "result"}]

    first = run_cli(head + [{"op": "drive", "until": 60.0},
                            {"op": "checkpoint"}], *ck)
    assert all(r["ok"] for r in first)
    assert first[-1]["step"] == 0

    second = run_cli(tail + finish, *ck, "--restore")
    assert all(r["ok"] for r in second)
    banner = second[0]
    assert banner["resumed"] and banner["n_submitted"] == 2

    solo = run_cli(STREAM + finish)
    decided = [d for r in first + second for d in r.get("decisions", [])]
    assert decided == [d for r in solo for d in r.get("decisions", [])]
    assert len(decided) == 4
    assert solo[-1]["totals"] == second[-1]["totals"]
    assert solo[-1]["n_jobs"] == second[-1]["n_jobs"] == 4


# ------------------------------------------------------------ pool mode

POOL = ["--pool", "4"]
#: four distinct per-session program orders over one shared arrival grid
PROGS = [["BT", "LU", "SP", "EP"], ["LU", "BT", "EP", "SP"],
         ["SP", "EP", "BT", "LU"], ["EP", "SP", "LU", "BT"]]


def _psub(i, j):
    return {"op": "submit", "session": i,
            "prog": PROGS[i][j], "arrival": 30.0 * j}


def test_handle_pool_matches_the_reference(tmp_path):
    """The ``--pool`` protocol in process: envelope and fan-out requests,
    errors included, answered as the reference's ``handle_pool`` answers
    them (latency aside)."""
    from repro.service import SessionPool as RPool
    from repro_torch.service import SessionPool
    ap = argparse.ArgumentParser()
    r_args.add_policy_options(ap)
    ra = ap.parse_known_args(ARGV)[0]
    ap = argparse.ArgumentParser()
    t_args.add_policy_options(ap)
    ta = ap.parse_known_args(ARGV)[0]
    ref = RPool.replicate(
        RScheduler(r_args.build_policy(ra), warm_start=True), 4,
        r_npb(R_SYSTEMS), capacity=16, checkpoint_dir=str(tmp_path / "r"),
        decision_log=str(tmp_path / "r.jsonl"))
    port = SessionPool.replicate(
        Scheduler(t_args.build_policy(ta), warm_start=True, device="cpu"),
        4, make_npb_workload(JSCC_SYSTEMS), capacity=16,
        checkpoint_dir=str(tmp_path / "t"),
        decision_log=str(tmp_path / "t.jsonl"))
    reqs = ([_psub(i, j) for j in (0, 1) for i in range(4)]
            + [{"op": "drive", "until": 45.0, "session": 2},
               {"op": "drive", "until": 60.0},
               {"op": "checkpoint"}, {"op": "checkpoint", "session": 1},
               {"op": "whatif", "session": 3, "prog": "IS"},
               {"op": "whatif", "prog": 2, "arrival": 900.0},
               {"op": "submit", "session": 7, "prog": "BT"},
               {"op": "submit", "session": 0, "prog": "nope"},
               {"op": "bogus"}]
            + [_psub(i, j) for j in (2, 3) for i in range(4)]
            + [{"op": "restore", "session": 0}, _psub(0, 2), _psub(0, 3),
               {"op": "drain", "session": 1}, {"op": "drain"},
               {"op": "metrics"}, {"op": "metrics", "session": 2},
               {"op": "result"}]
            + [{"op": "result", "session": i} for i in range(4)])
    for req in reqs:
        resp = []
        for handle, p in ((r_cli.handle_pool, ref), (t_cli.handle_pool,
                                                      port)):
            try:
                r = handle(p, req)
            except Exception as e:          # as main() reports it
                r = {"ok": False, "error": str(e)}
            resp.append(json.loads(json.dumps(r)))
        _same(resp[0], resp[1], f"{req}")
    ref.close()
    port.close()
    logs = [[json.loads(line) for line in (tmp_path / f).read_text()
             .splitlines()] for f in ("r.jsonl", "t.jsonl")]
    _same(*logs)
    assert {(r["session"], r["job"]) for r in logs[1]} >= {
        (i, j) for i in range(4) for j in range(4)}


@pytest.mark.slow
def test_pool_kill_and_restore_per_session(tmp_path):
    """Four sessions over one loop, checkpointed mid-stream into
    per-session namespaces, killed, ``--restore``d in a new process and
    finished: per-session results equal an uninterrupted pool's, and the
    decision logs of the two processes together carry every decision of
    the uninterrupted pool's, each with its session."""
    ck = ["--checkpoint-dir", str(tmp_path / "ck")]
    head = [_psub(i, j) for j in (0, 1) for i in range(4)]
    tail = [_psub(i, j) for j in (2, 3) for i in range(4)]
    finish = ([{"op": "drain"}]
              + [{"op": "result", "session": i} for i in range(4)]
              + [{"op": "metrics"}])
    logs = [str(tmp_path / f"{n}.jsonl") for n in ("a", "b", "solo")]

    first = run_cli(head + [{"op": "drive", "until": 60.0},
                            {"op": "checkpoint"}], *POOL, *ck,
                    "--decision-log", logs[0])
    assert all(r["ok"] for r in first)
    assert first[-1]["steps"] == [0, 0, 0, 0]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["s000", "s001", "s002", "s003"]

    second = run_cli(tail + finish, *POOL, *ck, "--restore",
                     "--decision-log", logs[1])
    assert all(r["ok"] for r in second)
    banner = second[0]
    assert banner["resumed"] and banner["sessions"] == 4
    assert banner["n_submitted"] == [2, 2, 2, 2]

    solo = run_cli(head + tail + finish, *POOL, "--decision-log", logs[2])
    assert solo[-5:-1] == second[-5:-1]          # 4 per-session results
    for i in range(4):
        m = second[-1]["metrics"][str(i)]
        assert m["n_submitted"] == 4 and m["n_finished"] == 4
        assert m["queue_depth"] == 0
    recs = [[json.loads(line) for line in open(f)] for f in logs]
    key = lambda r: (r["session"], r["job"])  # noqa: E731
    assert sorted(recs[0] + recs[1], key=key) == sorted(recs[2], key=key)
    assert len(recs[2]) == 16
