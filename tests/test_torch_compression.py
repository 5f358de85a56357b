"""Port parity: int8 error-feedback compression
(``repro_torch.optim.compression``) against the reference's
(``repro.optim.compression``) on the CPU.

Bands (PERF.md "Parity bands"):
  quantize_int8, dequantize_int8,   bit-equal to the reference's eager
  compress_with_feedback            calls (``torch.round`` and
                                    ``jnp.round`` both round half to
                                    even; exact .5 ties and an all-zero
                                    tensor included)
  compressed_psum vs the            each member's new residual bit-equal;
  reference's ``jax.vmap`` form     the mean within rtol 1e-6 (the vmapped
  (``tests/test_optim.py:83``)      psum adds the members in its own
                                    order); both within 0.05 of the true
                                    mean, the reference's own band
  error-feedback SGD                converges to the target within 0.05,
                                    the reference's own case
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

from repro.optim import compression as jc  # noqa: E402
from repro_torch.optim import compression as tc  # noqa: E402


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4099) * rng.uniform(1e-3, 30)).astype(np.float32)
    e = (rng.standard_normal(4099) * 1e-3).astype(np.float32)
    return x, e


# scale 1 (amax 127) and 2 (amax 254): every entry an exact .5 tie
TIES = [np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5],
                 np.float32),
        np.array([254, 1, 3, 5, -1, -3, 7, -253], np.float32)]


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "ties127",
                                  "ties254", "zeros"])
def test_quantizers_are_bit_equal(case):
    if case.startswith("seed"):
        x = _inputs(int(case[-1]))[0]
    elif case == "zeros":
        x = np.zeros(64, np.float32)
    else:
        x = TIES[case == "ties254"]
    jq, js = jc.quantize_int8(jnp.asarray(x))
    q, s = tc.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(tc.dequantize_int8(q, s).numpy(),
                                  np.asarray(jc.dequantize_int8(jq, js)))
    if case == "ties127":          # half to even: 0.5 -> 0, 1.5 -> 2
        assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126]
    if case == "zeros":
        assert not q.any() and float(s) == float(np.float32(1e-12) / 127)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_with_feedback_is_bit_equal(seed):
    x, e = _inputs(seed)
    jq, js, je = jc.compress_with_feedback(jnp.asarray(x), jnp.asarray(e))
    q, s, new_e = tc.compress_with_feedback(torch.from_numpy(x),
                                            torch.from_numpy(e))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(new_e.numpy(), np.asarray(je))
    # the residual carries what quantization dropped
    np.testing.assert_allclose(tc.dequantize_int8(q, s).numpy()
                               + new_e.numpy(), x + e, atol=1e-6)


def test_bf16_gradient_widens_before_the_residual():
    x, e = _inputs(3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jq, js, je = jc.compress_with_feedback(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), jnp.asarray(e))
    q, s, new_e = tc.compress_with_feedback(xb, torch.from_numpy(e))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(new_e.numpy(), np.asarray(je))


def test_quantize_roundtrip_error_bounded():
    x = torch.randn(1024, generator=torch.Generator().manual_seed(0)) * 3
    q, s = tc.quantize_int8(x)
    err = tc.dequantize_int8(q, s) - x
    assert float(err.abs().max()) <= float(s) * 0.5 + 1e-6


@pytest.mark.parametrize("n_dev", [2, 4])
def test_compressed_psum_matches_the_vmapped_reference(n_dev):
    rng = np.random.default_rng(n_dev)
    grads = rng.standard_normal((n_dev, 64)).astype(np.float32)
    errs = (rng.standard_normal((n_dev, 64)) * 1e-2).astype(np.float32)

    def worker(g, e):
        out, new_e = jc.compressed_psum({"g": g}, {"g": e}, "dp")
        return out["g"], new_e["g"]

    jout, jerr = jax.vmap(worker, axis_name="dp")(jnp.asarray(grads),
                                                  jnp.asarray(errs))
    mean, new_errs = tc.compressed_psum(
        [{"g": torch.from_numpy(g)} for g in grads],
        [{"g": torch.from_numpy(e)} for e in errs])
    assert len(new_errs) == n_dev
    for i in range(n_dev):
        np.testing.assert_array_equal(new_errs[i]["g"].numpy(),
                                      np.asarray(jerr[i]))
        np.testing.assert_allclose(mean["g"].numpy(), np.asarray(jout[i]),
                                   rtol=1e-6, atol=1e-7)
    true_mean = grads.mean(0)
    np.testing.assert_allclose(mean["g"].numpy(), true_mean, atol=0.05)
    with pytest.raises(ValueError):
        tc.compressed_psum([{"g": torch.zeros(3)}] * 2,
                           [{"g": torch.zeros(3)}])


def test_per_layer_leaves_share_their_stacked_scale():
    """The port's per-layer leaves ``layers/<i>/w`` of the reference's one
    stacked leaf [L, ...], quantized with ``tensor_of``: one scale over
    the layers, each member's residual bit-equal to the reference's on
    the stacked tensor.  Without ``tensor_of`` such a tree is refused."""
    n_dev, n_layers = 2, 3
    rng = np.random.default_rng(5)
    grads = (rng.standard_normal((n_dev, n_layers, 32))
             * np.array([1.0, 0.1, 0.01])[:, None]).astype(np.float32)
    errs = (rng.standard_normal((n_dev, n_layers, 32)) * 1e-3).astype(
        np.float32)

    def worker(g, e):
        out, new_e = jc.compressed_psum({"w": g}, {"w": e}, "dp")
        return out["w"], new_e["w"]

    jout, jerr = jax.vmap(worker, axis_name="dp")(jnp.asarray(grads),
                                                  jnp.asarray(errs))

    def layered(a):
        return {"layers": [{"w": torch.from_numpy(a[i].copy())}
                           for i in range(n_layers)]}
    mean, new_errs = tc.compressed_psum(
        [layered(g) for g in grads], [layered(e) for e in errs],
        lambda name: name.split("/")[-1])
    for d in range(n_dev):
        for i in range(n_layers):
            np.testing.assert_array_equal(
                new_errs[d]["layers"][i]["w"].numpy(), np.asarray(jerr[d, i]))
            np.testing.assert_allclose(mean["layers"][i]["w"].numpy(),
                                       np.asarray(jout[d, i]), rtol=1e-6,
                                       atol=1e-7)
    with pytest.raises(ValueError, match="tensor_of"):
        tc.compressed_psum([layered(g) for g in grads],
                           [layered(e) for e in errs])


def test_error_feedback_sgd_converges():
    """EF-SGD on a least-squares problem: w -> target despite
    compression (the reference's ``tests/test_optim.py`` case)."""
    n_dev = 4
    gen = torch.Generator().manual_seed(0)
    target = torch.linspace(-1, 1, 16)
    w = [torch.zeros(16) for _ in range(n_dev)]
    err = [{"g": torch.zeros(16)} for _ in range(n_dev)]
    for _ in range(300):
        grads = [{"g": 2 * (wi - target) + torch.randn(16, generator=gen)
                  * 0.1} for wi in w]
        mg, err = tc.compressed_psum(grads, err)
        w = [wi - 0.05 * mg["g"] for wi in w]
    np.testing.assert_allclose(w[0].numpy(), target.numpy(), atol=0.05)
    assert all(torch.equal(w[0], wi) for wi in w)


def test_init_error_state_is_zero_f32():
    params = {"a": torch.ones(3, dtype=torch.bfloat16),
              "b": [torch.ones((2, 2))]}
    e = tc.init_error_state(params)
    assert e["a"].dtype == torch.float32 and not e["a"].any()
    assert e["b"][0].shape == (2, 2)
