"""Port parity: the torch threefry2x32 (repro_torch.utils.prng) against
``jax.random`` bit for bit, for exactly the draws the engine makes:
``key(seed)``, ``split``, ``fold_in(key, j)``, ``uniform(key, (2,))``
(fault factors) and ``randint(key, (), 0, S)`` (the ``random``
objective)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

from repro_torch.utils import prng  # noqa: E402

SEEDS = (0, 1, 7, 2 ** 31 - 1)
# counters across the 16-bit boundary and up to a million-job stream
JS = np.array([0, 1, 2, 3, 255, 256, 65535, 65536, 99_999, 123_457,
               999_999, 1_000_000], np.int32)


def _jax_keys(seed):
    k = jax.random.key(jnp.int32(seed))
    return k, jax.random.split(k)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_match_jax(seed):
    k, ks = _jax_keys(seed)
    tk = prng.key(seed)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jax.random.key_data(k)))
    np.testing.assert_array_equal(prng.split(tk).numpy(),
                                  np.asarray(jax.random.key_data(ks)))
    np.testing.assert_array_equal(
        prng.split(tk, 5).numpy(),
        np.asarray(jax.random.key_data(jax.random.split(k, 5))))


def test_batched_keys_match_per_seed():
    tk = prng.split(prng.key(torch.tensor(SEEDS, dtype=torch.int32)))
    for i, seed in enumerate(SEEDS):
        _, ks = _jax_keys(seed)
        np.testing.assert_array_equal(tk[i].numpy(),
                                      np.asarray(jax.random.key_data(ks)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_uniform_randint_match_jax(seed):
    _, ks = _jax_keys(seed)
    sel_key, fault_key = ks[0], ks[1]
    js = jnp.asarray(JS)
    t_sel, t_fault = prng.split(prng.key(seed)).unbind(0)
    tj = torch.from_numpy(JS.astype(np.int64))

    jf = jax.vmap(lambda j: jax.random.fold_in(fault_key, j))(js)
    tf = prng.fold_in(t_fault, tj)
    np.testing.assert_array_equal(tf.numpy(),
                                  np.asarray(jax.random.key_data(jf)))
    np.testing.assert_array_equal(
        prng.uniform(tf, (2,)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (2,)))(jf)))

    js_sel = jax.vmap(lambda j: jax.random.fold_in(sel_key, j))(js)
    ts = prng.fold_in(t_sel, tj)
    for S in (4, 12, 7):
        ref = jax.vmap(lambda k: jax.random.randint(k, (), 0, S))(js_sel)
        out = prng.randint(ts, (), 0, S)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_campaign_grid_draws_match_jax():
    """The engine's whole [B, J] fault draw in one pass equals the
    reference's per-step draws."""
    seeds = (0, 3, 7)
    J = 500
    t_fault = prng.split(prng.key(torch.tensor(seeds))).unbind(1)[1]
    tu = prng.uniform(prng.fold_in(t_fault[:, None, :], torch.arange(J)),
                      (2,))                                   # [B, J, 2]
    for b, seed in enumerate(seeds):
        _, ks = _jax_keys(seed)
        ref = jax.vmap(lambda j: jax.random.uniform(
            jax.random.fold_in(ks[1], j), (2,)))(jnp.arange(J))
        np.testing.assert_array_equal(tu[b].numpy(), np.asarray(ref))


# ---------------------------------------------- the NPB workloads' draws

@pytest.mark.parametrize("seed,fold", [(0, 0), (0, 3), (5, 4095)])
def test_uniform_bounds_match_jax(seed, fold):
    """EP's ``uniform(fold_in(key, i), (2, n), minval=-1, maxval=1)``,
    bit for bit; also the [0, 1) default and a non-symmetric range (all
    with power-of-two spans, as every caller's)."""
    jk = jax.random.fold_in(jax.random.key(seed), fold)
    tk = prng.fold_in(prng.key(seed), fold)
    for lo, hi in ((-1.0, 1.0), (0.0, 1.0), (2.5, 6.5)):
        ref = jax.random.uniform(jk, (2, 4096), minval=lo, maxval=hi)
        out = prng.uniform(tk, (2, 4096), lo, hi)
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_uniform_batched_keys_match_jax():
    """Many batch keys in one pass: ``[B, 2]`` keys give ``[B, *shape]``."""
    keys = prng.fold_in(prng.key(0), torch.arange(6))
    out = prng.uniform(keys, (2, 512), -1.0, 1.0)
    for i in range(6):
        ref = jax.random.uniform(jax.random.fold_in(jax.random.key(0), i),
                                 (2, 512), minval=-1.0, maxval=1.0)
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(ref))


@pytest.mark.parametrize("maxval", [2 ** 19, 2 ** 26, 1000])
@pytest.mark.parametrize("fold", [0, 9])
def test_randint_vector_matches_jax(maxval, fold):
    """IS's ``randint(fold_in(key, i), (n,), 0, 2**(n_pow + 3))``."""
    jk = jax.random.fold_in(jax.random.key(0), fold)
    ref = jax.random.randint(jk, (65536,), 0, maxval, jnp.int32)
    out = prng.randint(prng.fold_in(prng.key(0), fold), (65536,), 0, maxval)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


#: ``normal`` band: torch.erfinv against XLA's erf_inv (at most 5.4e-6
#: relative, 2.1e-5 absolute seen on 64^3 draws)
NORMAL_RTOL = 1e-5
NORMAL_ATOL = 1e-6


@pytest.mark.parametrize("seed,shape", [(0, (24, 24, 24)), (3, (64, 64, 64)),
                                        (1, (1000,))])
def test_normal_within_band(seed, shape):
    ref = np.asarray(jax.random.normal(jax.random.key(seed), shape,
                                       jnp.float32))
    out = prng.normal(prng.key(seed), shape)
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=NORMAL_RTOL,
                               atol=NORMAL_ATOL)
    assert np.isfinite(out.numpy()).all()
