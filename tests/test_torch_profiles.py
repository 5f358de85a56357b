"""Port parity: the profile store, the paper's energy formalism and the
legacy ``select_system`` front-end (repro_torch.core.{profiles, energy,
algorithm}) against the reference's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

from repro.core import energy as j_energy  # noqa: E402
from repro.core.algorithm import MODES as J_MODES  # noqa: E402
from repro.core.algorithm import select_system as j_select  # noqa: E402
from repro.core.profiles import ProfileStore as JStore  # noqa: E402
from repro.core.profiles import k_auto as j_k_auto  # noqa: E402
from repro_torch.core import energy  # noqa: E402
from repro_torch.core.algorithm import MODES, select_system  # noqa: E402
from repro_torch.core.profiles import ProfileStore, k_auto  # noqa: E402
from repro_torch.utils import prng  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_profile_store_updates_match_reference(seed):
    rng = np.random.default_rng(seed)
    P, S = 5, 4
    a, b = ProfileStore(P, S), JStore(P, S)
    for _ in range(200):
        p, s = int(rng.integers(P)), int(rng.integers(S))
        c, t = float(rng.uniform(1e-4, 1.0)), float(rng.uniform(1, 1e4))
        a.update(p, s, c, t)
        b.update(p, s, c, t)
        np.testing.assert_array_equal(a.known(p), b.known(p))
        assert a.fully_explored() == b.fully_explored()
    for f in ("C", "T", "runs"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype


@pytest.mark.parametrize("t_max,t_hist", [(100.0, 80.0), (80.0, 100.0),
                                          (5.0, 0.0), (3.0, -1.0),
                                          (1e4, 1e4)])
def test_k_auto_matches_reference(t_max, t_hist):
    assert k_auto(t_max, t_hist) == j_k_auto(t_max, t_hist)


# the energy formalism against repro.core.energy on the same inputs: values
# and dtypes equal, except average_power's f32 sums (another summation order,
# rtol 1e-6; see PERF.md "Parity bands")

def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_same(out, ref):
    out, ref = _np(out), _np(ref)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


def _assert_close(out, ref):
    out, ref = _np(out), _np(ref)
    assert out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


def test_node_power_is_component_sum():
    _assert_same(energy.node_power(100.0, 10.0, 5.0),
                 j_energy.node_power(100.0, 10.0, 5.0))
    assert float(energy.node_power(100.0, 10.0, 5.0)) == 115.0
    rng = np.random.default_rng(0)
    parts = [rng.uniform(0, 300, (4, 50)) for _ in range(3)]
    _assert_same(energy.node_power(*parts), j_energy.node_power(*parts))
    parts = [x.astype(np.float32) for x in parts]
    _assert_same(energy.node_power(*map(torch.from_numpy, parts)),
                 j_energy.node_power(*map(jnp.asarray, parts)))


def test_average_power_constant_trace():
    w = np.full((4, 11), 50.0)      # 4 nodes, 50 W each, 10 s
    _assert_same(energy.average_power(w, dt=1.0),
                 j_energy.average_power(w, dt=1.0))
    assert float(energy.average_power(w, dt=1.0)) == 200.0


def test_average_power_matches_trapezoid():
    t = np.linspace(0, 10, 11)
    w = np.stack([t, 2 * t])        # two ramping nodes
    for dt in (1.0, 0.5):
        _assert_same(energy.average_power(w, dt=dt),
                     j_energy.average_power(w, dt=dt))
        _assert_same(energy.average_power(torch.from_numpy(w), dt=dt),
                     j_energy.average_power(w, dt=dt))


@pytest.mark.parametrize("seed", range(4))
def test_average_power_seeded_traces_match_reference(seed):
    rng = np.random.default_rng(seed)
    n, t = int(rng.integers(1, 9)), int(rng.integers(2, 400))
    w = rng.uniform(0, 500, (n, t))
    w_int = rng.integers(0, 500, (n, t))
    for dt in (1.0, 0.5, 0.1, 3.7):
        _assert_close(energy.average_power(w, dt=dt),
                      j_energy.average_power(w, dt=dt))
        _assert_close(energy.average_power(w.astype(np.float32), dt=dt),
                      j_energy.average_power(w.astype(np.float32), dt=dt))
        _assert_close(energy.average_power(w_int, dt=dt),
                      j_energy.average_power(w_int, dt=dt))


def test_energy_coefficient_units():
    # C = W / P: 1000 W at 1e6 Mop/s -> 1e-3 J/Mop
    _assert_same(energy.energy_coefficient(1000.0, 1e6),
                 j_energy.energy_coefficient(1000.0, 1e6))
    _assert_same(energy.energy_coefficient(1000, 0),
                 j_energy.energy_coefficient(1000, 0))
    rng = np.random.default_rng(1)
    w, p = rng.uniform(0, 1e4, 64), rng.uniform(0, 1e6, 64)
    p[:3] = 0.0
    _assert_same(energy.energy_coefficient(w, p),
                 j_energy.energy_coefficient(w, p))
    _assert_close(energy.energy_coefficient(energy.average_power(w[None]), p),
                 j_energy.energy_coefficient(j_energy.average_power(w[None]),
                                             p))
    assert energy.profile(5, 0.1) == j_energy.profile(5, 0.1) == \
        {"K": 5, "C": 0.1}


def _rows(rng, cold):
    S = 4
    runs = (rng.integers(0, 3, S) if cold else rng.integers(1, 4, S))
    c = rng.uniform(0.1, 1.0, S).astype(np.float32)
    t = rng.uniform(10, 100, S).astype(np.float32)
    if rng.random() < 0.3:
        c[1] = c[2]                                   # exact C tie
    c = np.where(runs > 0, c, 0).astype(np.float32)
    t = np.where(runs > 0, t, 0).astype(np.float32)
    return dict(c_row=c, t_row=t, runs_row=runs.astype(np.int32),
                avail_row=rng.uniform(0, 100, S).astype(np.float32),
                c_pred_row=rng.uniform(0.1, 1.0, S).astype(np.float32),
                t_pred_row=rng.uniform(10, 100, S).astype(np.float32))


@pytest.mark.parametrize("cold", [False, True], ids=["warm", "cold"])
@pytest.mark.parametrize("mode", J_MODES)
def test_select_system_matches_reference(mode, cold):
    assert MODES == J_MODES
    rng = np.random.default_rng(hash((mode, cold)) % 2 ** 32)
    for trial in range(40):
        rows = _rows(rng, cold)
        k = np.float32(rng.choice([0.0, 0.05, 0.1, 0.3]))
        ref = j_select(mode, k=k, key=jax.random.key(trial),
                       **{n: jnp.asarray(v) for n, v in rows.items()})
        out = select_system(mode, k=torch.tensor(k), key=prng.key(trial),
                            **{n: torch.from_numpy(v)
                               for n, v in rows.items()})
        assert int(out) == int(ref), (mode, cold, trial, rows)
