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
