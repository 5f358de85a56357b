"""The plain reference against the port's CPU run: its own tables equal
the port's front end's, its draws the port's threefry, and its FCFS and
EASY campaigns the port's ``Scheduler`` on a few lanes with faults, every
total and table bit for bit."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import correct, generator
from portbench.reference import prng, sched

torch = pytest.importorskip("torch")
from repro_torch.core import FaultConfig, Scheduler, make_policy  # noqa: E402
from repro_torch.utils import prng as tprng  # noqa: E402

from portbench import program  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
#: faults frequent enough that stragglers and restarts move every lane
FAULTS = dict(straggler_prob=0.3, straggler_factor=2.0, failure_prob=0.2,
              restart_overhead=0.5)
SEEDS = (7, 2 ** 31 - 1, 123456)


def _conf(name):
    return json.loads((ROOT / "portbench" / "configs" /
                       f"{name}.json").read_text())


def _mix(name, jobs=1000):
    return {**json.loads((ROOT / "portbench" / "traffic" /
                          f"{name}.json").read_text()), "jobs": jobs}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_threefry_draws_match_the_ports():
    seeds = np.array([0, 1, 7, 2 ** 31 - 1, 123456789])
    keys = prng.split(prng.key(seeds))
    tkeys = tprng.split(tprng.key(torch.as_tensor(seeds, dtype=torch.int32)))
    np.testing.assert_array_equal(keys.astype(np.int64), tkeys.numpy())
    jobs = np.arange(300)
    u = prng.uniform(prng.fold_in(keys[:, 1, None, :], jobs[None, :]), 2)
    tu = tprng.uniform(tprng.fold_in(tkeys[:, 1, None, :],
                                     torch.as_tensor(jobs)[None, :]), (2,))
    np.testing.assert_array_equal(u, tu.numpy())


@pytest.mark.parametrize("mix", ["npb-poisson", "swf-contended"])
def test_tables_match_the_ports_front_end(mix):
    conf = _conf("jscc-fcfs")
    traffic = generator.generate(_mix(mix), 3)
    w = program.build_workload(traffic, conf)
    tab = correct.reference_tables(traffic, conf, 1000)
    for f in ("T", "C", "E"):
        want = torch.as_tensor(np.asarray(getattr(w, f + "_true"))).float()
        np.testing.assert_array_equal(tab[f], want.numpy())
    np.testing.assert_array_equal(tab["n_req"], np.asarray(w.n_req))
    np.testing.assert_array_equal(tab["prog"], np.asarray(w.prog))
    np.testing.assert_array_equal(tab["arrival"], np.asarray(w.arrival))
    np.testing.assert_array_equal(tab["idle_w"], np.asarray(w.idle_w))
    assert tab["free0"].shape == (4, int(np.max(w.n_nodes)))


def _port(conf, traffic, jobs):
    w = program.build_workload(traffic, conf)
    w = dataclasses.replace(w, prog=w.prog[:jobs], arrival=w.arrival[:jobs],
                            k_job=w.k_job[:jobs])
    res = Scheduler(make_policy("paper", k=np.asarray(conf["k_grid"],
                                                      np.float32)),
                    seeds=SEEDS, faults=FaultConfig(**FAULTS),
                    warm_start=True, queue=conf["queue"],
                    device="cpu").run(w, totals_only=True)
    return {f: getattr(res, f).flatten(0, 1).numpy() for f in program.FIELDS}


def _lanes(conf):
    pairs = [(g, s) for g in range(len(conf["k_grid"])) for s in SEEDS]
    return correct.lane_inputs({**conf, "faults": FAULTS}, pairs)


@pytest.mark.parametrize("config,mix", [("jscc-fcfs", "npb-poisson"),
                                        ("jscc-easy16", "swf-contended"),
                                        ("jscc-easy16", "npb-poisson")])
def test_reference_equals_the_ports_cpu_run(config, mix):
    conf, jobs = _conf(config), 160
    traffic = generator.generate(_mix(mix), 5)
    got = _port(conf, traffic, jobs)
    want = correct.reference_run(correct.reference_tables(traffic, conf, jobs),
                                 conf, _lanes(conf))
    for f in program.FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    numbers = correct.compare(got, want)
    assert numbers == {"placements_diff": 0, "totals_rel_gap": 0.0}
    if conf["queue"].startswith("easy"):
        assert want["n_backfilled"].sum() > 0


def test_fma32_rounds_once():
    """``fma32`` is one rounding of the exact ``a * b + c``, which two
    float32 roundings miss on some inputs."""
    x = np.random.default_rng(0).random((3, 4000)).astype(np.float32) * 100
    fused = sched.fma32(x[0], x[1], x[2])
    exact = (x[0].astype(np.float64) * x[1] + x[2]).astype(np.float32)
    np.testing.assert_array_equal(fused, exact)
    assert (fused != (x[0] * x[1] + x[2])).any()
