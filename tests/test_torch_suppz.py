"""Port parity: the SUPPZ front end (``core/suppz.py``) against the
reference's ``repro.core.suppz``: the cases of ``tests/test_suppz.py``
on the port, and every decision and the decoded msgpack database equal
to the reference's on the same submissions (``device="cpu"``)."""

import dataclasses

import msgpack
import pytest

torch = pytest.importorskip("torch")

from repro.core import suppz as R  # noqa: E402
from repro_torch.core import suppz as T  # noqa: E402
from repro_torch.core.suppz import (Submission, SuppzFrontend,  # noqa: E402
                                    program_id)

SYS = ["KNL", "Broadwell", "Skylake", "CascadeLake"]
PROFILES = {"KNL": (1.0, 150.0), "Broadwell": (2.8, 130.0),
            "Skylake": (1.7, 76.0), "CascadeLake": (1.4, 80.0)}


@pytest.fixture
def fe(tmp_path):
    return SuppzFrontend(str(tmp_path / "suppz.msgpack"), SYS, device="cpu")


def test_program_identity_is_executable_hash():
    assert program_id(b"binary-A") != program_id(b"binary-B")
    assert program_id(b"binary-A") == program_id(b"binary-A")
    assert program_id(b"binary-A") == R.program_id(b"binary-A")


def test_never_run_explores_first_released(fe):
    d = fe.submit(Submission(b"prog", np_=144, t_max=600.0),
                  availability=[5.0, 1.0, 3.0, 4.0])
    assert d.explored and d.system == "Broadwell"   # earliest available
    assert d.auto_queued


def test_pinned_type_is_notification_only(fe):
    d = fe.submit(Submission(b"prog", np_=144, t_max=600.0,
                             resource_type="Skylake"))
    assert not d.auto_queued


def test_learning_and_k_auto(fe):
    exe = b"my-solver-v1"
    for s, (c, t) in PROFILES.items():
        fe.report_completion(exe, s, c=c, t=t)
    d = fe.submit(Submission(exe, np_=144, t_max=600.0, k=0.10))
    assert not d.explored and d.system == "CascadeLake"
    assert fe.submit(Submission(exe, np_=144, t_max=600.0,
                                k=0.0)).system == "Skylake"
    da = fe.submit(Submission(exe, np_=144, t_max=83.0))
    assert da.k_used == pytest.approx(83.0 / 76.0 - 1.0, rel=1e-6)
    assert da.system == "CascadeLake"


def test_persistence_across_restart(tmp_path):
    path = str(tmp_path / "db.msgpack")
    fe1 = SuppzFrontend(path, SYS, device="cpu")
    fe1.report_completion(b"p", "Skylake", c=1.5, t=100.0)
    fe1.submit(Submission(b"p", np_=16, t_max=200.0))
    fe2 = SuppzFrontend(path, SYS, device="cpu")
    ent = fe2.db["programs"][program_id(b"p")]
    assert ent["runs"]["Skylake"] == 1
    assert ent["T"]["Skylake"] == pytest.approx(100.0)


def test_repeat_completions_average(fe):
    exe = b"q"
    fe.report_completion(exe, "KNL", c=2.0, t=100.0)
    fe.report_completion(exe, "KNL", c=4.0, t=200.0)
    ent = fe.db["programs"][program_id(exe)]
    assert ent["C"]["KNL"] == pytest.approx(3.0)
    assert ent["T"]["KNL"] == pytest.approx(150.0)
    assert ent["runs"]["KNL"] == 2


def _session(mod, path, kw):
    """Five NPB programs: first submissions (exploration, some pinned),
    measured completions, resubmissions with admin and automatic K."""
    fe = mod.SuppzFrontend(path, SYS, **kw)
    out = []
    for i, prog in enumerate(("BT", "EP", "IS", "LU", "SP")):
        exe = f"npb-{prog}".encode()
        out.append(fe.submit(mod.Submission(
            exe, np_=16 * (i + 1), t_max=300.0 + 50 * i,
            resource_type="Skylake" if i == 3 else None),
            availability=[float((i + s) % 4) for s in range(4)]))
        for j, (s, (c, t)) in enumerate(PROFILES.items()):
            mod_c, mod_t = c * (1 + 0.1 * i), t * (1 + 0.05 * ((i + j) % 3))
            out.append(fe.report_completion(exe, s, c=mod_c, t=mod_t))
        out.append(fe.submit(mod.Submission(exe, np_=16, t_max=90.0 + i,
                                            k=0.05 * i)))
        out.append(fe.submit(mod.Submission(exe, np_=16, t_max=140.0)))
    return [None if d is None else dataclasses.asdict(d) for d in out]


def test_sessions_match_the_reference(tmp_path):
    """The same submissions through both front ends: the same decisions,
    and databases that decode to the same content."""
    rp, tp = str(tmp_path / "ref.msgpack"), str(tmp_path / "port.msgpack")
    ref = _session(R, rp, {})
    got = _session(T, tp, {"device": "cpu"})
    assert got == ref
    assert {d["system"] for d in ref if d} >= {"Skylake", "CascadeLake"}
    with open(rp, "rb") as a, open(tp, "rb") as b:
        assert msgpack.unpackb(b.read()) == msgpack.unpackb(a.read())
    # each reads the other's file
    assert T.SuppzFrontend(rp, SYS, device="cpu").db == \
        R.SuppzFrontend(tp, SYS).db


def test_default_device_is_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SuppzFrontend(str(tmp_path / "x.msgpack"), SYS)
