"""Port parity: system and program tables, the DVFS tier model and the
scenario generators (repro_torch.core / repro_torch.data) equal the
reference's.  The port keeps its own copies of these pure-numpy modules
because importing ``repro.core`` pulls in JAX."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import dvfs as r_dvfs  # noqa: E402
from repro.core import systems as r_sys  # noqa: E402
from repro.core import workload_model as r_wm  # noqa: E402
from repro.core.engine import _workload_arrays  # noqa: E402
from repro.data import scenarios as r_sc  # noqa: E402
from repro_torch.convert import workload_from_reference  # noqa: E402
from repro_torch.core import dvfs as t_dvfs  # noqa: E402
from repro_torch.core import systems as t_sys  # noqa: E402
from repro_torch.core import workload_model as t_wm  # noqa: E402
from repro_torch.core.engine import _workload_arrays as t_arrays  # noqa: E402
from repro_torch.data import scenarios as t_sc  # noqa: E402

_WL_FIELDS = ("prog", "arrival", "k_job", "n_req", "T_true", "C_true",
              "E_true", "T_pred", "C_pred", "n_nodes", "outage", "idle_w",
              "T_comp", "E_comp")


def _assert_workloads_equal(r, t):
    for f in _WL_FIELDS:
        a, b = getattr(r, f), getattr(t, f)
        if a is None:
            assert b is None, f
            continue
        assert np.asarray(a).dtype == np.asarray(b).dtype, f
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f)
    assert r.programs == t.programs and r.systems == t.systems


def test_systems_equal():
    assert set(r_sys.ALL_SYSTEMS) == set(t_sys.ALL_SYSTEMS)
    for name, rs in r_sys.ALL_SYSTEMS.items():
        assert dataclasses.asdict(rs) == dataclasses.asdict(
            t_sys.ALL_SYSTEMS[name])
    assert [s.name for s in t_sys.JSCC_SYSTEMS] == \
        [s.name for s in r_sys.JSCC_SYSTEMS]


def test_npb_tables_and_phase_split_equal():
    assert r_wm.NPB_NODES == t_wm.NPB_NODES
    assert {k: dataclasses.asdict(v) for k, v in r_wm.NPB_PROFILES.items()} \
        == {k: dataclasses.asdict(v) for k, v in t_wm.NPB_PROFILES.items()}
    progs = ("BT", "EP", "IS", "LU", "SP")
    rC, rT, rN = r_wm.npb_tables(r_sys.JSCC_SYSTEMS, progs)
    tC, tT, tN = t_wm.npb_tables(t_sys.JSCC_SYSTEMS, progs)
    for a, b in ((rC, tC), (rT, tT), (rN, tN)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(r_dvfs.npb_phase_split(r_sys.JSCC_SYSTEMS, progs, rN),
                    t_dvfs.npb_phase_split(t_sys.JSCC_SYSTEMS, progs, tN)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stream", [False, True])
def test_phase_split_and_tier_tables_equal(stream):
    """Tier tables on the engine's f32 inputs.  The reference computes
    them inside its compiled scan, where the multiply-adds are fused, so
    the port is held against the jitted reference."""
    if stream:     # no explicit phase split: the trace-workload defaults
        w = dataclasses.replace(
            r_sc.make_stream_workload(r_sys.JSCC_SYSTEMS, 50, seed=1),
            T_comp=None, E_comp=None)
    else:
        w = r_sc.make_npb_workload(r_sys.JSCC_SYSTEMS)
    tw = workload_from_reference(w)
    for a, b in zip(r_dvfs.phase_split(w), t_dvfs.phase_split(tw)):
        np.testing.assert_array_equal(a, b)
    tiers = (1.0, 0.8, 0.6, 0.45)
    ref = jax.jit(lambda a: r_dvfs.tier_tables(a, tiers))(_workload_arrays(w))
    out = t_dvfs.tier_tables(t_arrays(tw, "cpu"), tiers)
    assert set(ref) == set(out)
    for k in ref:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


def test_pareto_mask_equal():
    rng = np.random.default_rng(0)
    e = rng.integers(0, 6, 40).astype(float)
    m = rng.integers(0, 6, 40).astype(float)
    np.testing.assert_array_equal(r_dvfs.pareto_mask(e, m),
                                  t_dvfs.pareto_mask(e, m))


@pytest.mark.parametrize("kind", ["poisson", "diurnal", "bursty",
                                  "simultaneous"])
def test_arrivals_equal(kind):
    for seed in (0, 5):
        a = r_sc.make_arrivals(kind, 300, 0.5, seed)
        b = t_sc.make_arrivals(kind, 300, 0.5, seed)
        if a is None:
            assert b is None
            continue
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_program_mix_and_maintenance_windows_equal():
    mix = {("BT", "EP"): 0.3, "LU": 0.7}
    assert r_sc.sample_programs(200, seed=3) == t_sc.sample_programs(
        200, seed=3)
    assert r_sc.sample_programs(200, mix, seed=4) == t_sc.sample_programs(
        200, mix, seed=4)
    spans = {0: [(500, 900), (100, 200)], 3: [(50, 60)]}
    np.testing.assert_array_equal(r_sc.maintenance_windows(4, spans),
                                  t_sc.maintenance_windows(4, spans))
    with pytest.raises(ValueError):
        t_sc.maintenance_windows(4, {1: [(9, 3)]})


@pytest.mark.parametrize("arrival", ["poisson", "diurnal", "bursty"])
def test_stream_workloads_equal(arrival):
    out = r_sc.maintenance_windows(4, {1: [(100, 300)]})
    kw = dict(n_jobs=120, arrival=arrival, rate=0.5, seed=2, pred_noise=0.1,
              k_job=np.linspace(0, 0.3, 120).astype(np.float32))
    r = r_sc.make_stream_workload(r_sys.JSCC_SYSTEMS, outage=out, **kw)
    t = t_sc.make_stream_workload(t_sys.JSCC_SYSTEMS, outage=out, **kw)
    _assert_workloads_equal(r, t)
    _assert_workloads_equal(r, workload_from_reference(r))
