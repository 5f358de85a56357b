"""Port parity: pure-SSM (Mamba-2) serving (``repro_torch.models.mamba``,
the SSM branch of ``models.transformer``, ``convert``, ``launch.serve``)
against the reference's (``repro``) on the CPU.

Both sides get the same parameters (the reference's init, carried across
by ``params_from_reference``) and the same inputs, made with numpy from a
seed.  The reference initialises ``A_log`` and ``dt_bias`` to 0, ``D``
and the norm scales to 1 and ``conv_b`` to 0, so every head would share
one decay: those leaves are moved off their init here, so that a mix-up
of heads, groups or per-head parameters shows.  The model is
``smoke_reduce(mamba2-780m)``: 4 layers, d_model 128, 16 SSD heads of 16,
state 16, chunk 32, an MLP (d_ff 256), f32.

Bands (f32 throughout; PERF.md "Parity bands"):
  conv, gated norm            rtol 1e-5, atol 1e-6
  softplus                    rtol 1e-6, atol 1e-38 (XLA flushes subnormal
                              results to zero)
  in_proj product             each side within 5e-6 of the f64 product
                              (values up to ~3.5, where an f32 ulp is
                              2.4e-7): torch and XLA round the same f32
                              sums differently
  mixer forward and decode    rtol 1e-5, atol 1e-5: that rounding passes
                              through the conv, the scan and out_proj's
                              sum over 256 channels (3.2e-6 seen)
  prefill / decode logits     rtol 1e-5, atol 5e-5; greedy tokens exact:
                              the same rounding through four layers and
                              the tied head (2.0e-5 seen at 256 tokens,
                              logits up to 4.1)
  prefill vs decode chain     atol 2e-3 outputs and states, 1e-4 conv
                              tail (the reference's own bands,
                              tests/test_model_equivalence.py)
  params_from_reference       exact, bit for bit
"""

import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import mamba  # noqa: E402

ARCH = "mamba2-780m"
LAYER = dict(rtol=1e-5, atol=1e-6)
MIXER = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-5, atol=5e-5)
_JIGGLE = re.compile(r"scale|A_log|dt_bias|conv_b|\['D'\]")


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfg_pair(**kw):
    ref = jconfigs.smoke_reduce(jconfigs.get_config(ARCH)).with_overrides(**kw)
    port = configs.smoke_reduce(configs.get_config(ARCH)).with_overrides(**kw)
    return ref, port


def _jiggle(tree, seed):
    """Move the per-head leaves, conv bias and norm scales off their
    constant init (numpy tree in, numpy tree out)."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        if _JIGGLE.search(jax.tree_util.keystr(path)):
            return a + (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(move, tree)


@pytest.fixture(scope="module")
def mixer():
    """(ref cfg, port cfg, numpy mixer params), jiggled."""
    jcfg, cfg = _cfg_pair()
    p = jax.tree.map(np.asarray, jmamba.init_mamba(jcfg, jax.random.key(1),
                                                   jnp.float32))
    return jcfg, cfg, _jiggle(p, 1)


def _u(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------- pieces

def test_init_has_the_reference_leaves():
    jcfg, cfg = _cfg_pair()
    ref = jmamba.init_mamba(jcfg, jax.random.key(0), jnp.bfloat16)
    own = mamba.init_mamba(cfg, torch.Generator().manual_seed(0),
                           torch.bfloat16)
    assert sorted(own) == sorted(ref)
    for k, v in ref.items():
        assert tuple(own[k].shape) == v.shape, k
        assert str(own[k].dtype).split(".")[-1] == v.dtype.name, k
    assert float(own["A_log"].abs().max()) == 0.0
    assert bool((own["D"] == 1).all()) and not own["conv_b"].any()
    # conv kernel: unit normal times K^-0.5
    w = own["conv_w"].float()
    assert abs(float(w.std()) * cfg.ssm.conv_kernel ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv_matches_reference(mixer, with_prev):
    jcfg, cfg, p = mixer
    rng = np.random.default_rng(2)
    _, _, conv_dim = mamba._dims(cfg)
    xbc = rng.standard_normal((2, 9, conv_dim)).astype(np.float32)
    prev = (rng.standard_normal((2, cfg.ssm.conv_kernel - 1, conv_dim))
            .astype(np.float32) if with_prev else None)
    out, tail = mamba._causal_conv(
        _t(xbc), _t(p["conv_w"]), _t(p["conv_b"]),
        None if prev is None else _t(prev))
    jout, jtail = jmamba._causal_conv(
        jnp.asarray(xbc), jnp.asarray(p["conv_w"]), jnp.asarray(p["conv_b"]),
        None if prev is None else jnp.asarray(prev))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **LAYER)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))


def test_gated_norm_and_softplus_match_reference(mixer):
    jcfg, cfg, p = mixer
    rng = np.random.default_rng(3)
    d_inner = mamba._dims(cfg)[0]
    y, z = (rng.standard_normal((2, 5, d_inner)).astype(np.float32) * 3
            for _ in range(2))
    out = mamba._gated_norm(_t(y), _t(z), _t(p["norm_scale"]), cfg.norm_eps)
    ref = jmamba._gated_norm(jnp.asarray(y), jnp.asarray(z),
                             jnp.asarray(p["norm_scale"]), jcfg.norm_eps)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER)
    x = np.array([-100.0, -20.0, -1.0, 0.0, 1e-3, 1.0, 19.0, 21.0, 30.0,
                  100.0], np.float32)
    np.testing.assert_allclose(mamba._softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-38)


def test_projection_rounding_is_f32_noise(mixer):
    """The mixer's in_proj product, f32 on both sides: torch's and XLA's
    each lie within 5e-6 of the f64 product, so the mixer bands above
    are f32 rounding carried forward, not a difference in the math."""
    _, cfg, p = mixer
    u = _u(cfg, 2, 32, 4)
    exact = u.astype(np.float64) @ p["in_proj"].astype(np.float64)
    port = mamba.dot(_t(u), _t(p["in_proj"])).numpy()
    ref = np.asarray(jnp.einsum("bld,dk->blk", u, p["in_proj"],
                                preferred_element_type=jnp.float32))
    assert np.abs(exact).max() > 2.0
    np.testing.assert_allclose(port, exact, rtol=0, atol=5e-6)
    np.testing.assert_allclose(ref, exact, rtol=0, atol=5e-6)


@pytest.mark.parametrize("seq", [32, 96])
def test_mamba_forward_matches_reference(mixer, seq):
    jcfg, cfg, p = mixer
    u = _u(cfg, 2, seq, 4)
    out, (tail, state) = mamba.mamba_forward(
        {k: _t(v) for k, v in p.items()}, _t(u), cfg, return_state=True)
    jout, (jtail, jstate) = jax.jit(
        jmamba.mamba_forward, static_argnums=2,
        static_argnames="return_state")(
        jax.tree.map(jnp.asarray, p), jnp.asarray(u), jcfg, return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MIXER)
    np.testing.assert_allclose(tail.numpy(), np.asarray(jtail), **MIXER)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **MIXER)


def test_mamba_decode_matches_reference(mixer):
    jcfg, cfg, p = mixer
    rng = np.random.default_rng(5)
    (conv_shape, _), (state_shape, _) = mamba.mamba_decode_cache_specs(cfg, 3)
    conv = rng.standard_normal(conv_shape).astype(np.float32)
    state = rng.standard_normal(state_shape).astype(np.float32)
    u = _u(cfg, 3, 1, 6)
    out, c2, s2 = mamba.mamba_decode({k: _t(v) for k, v in p.items()},
                                     _t(u), cfg, _t(conv), _t(state))
    jout, jc2, js2 = jax.jit(jmamba.mamba_decode, static_argnums=2)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(u), jcfg,
        jnp.asarray(conv), jnp.asarray(state))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MIXER)
    np.testing.assert_allclose(c2.numpy(), np.asarray(jc2), **MIXER)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), **MIXER)


def test_prefill_state_equals_decode_chain(mixer):
    """The port's counterpart of ``tests/test_model_equivalence.py``'s
    ``test_mamba_prefill_equals_decode_chain``, with its bands."""
    _, cfg, p = mixer
    p = {k: _t(v) for k, v in p.items()}
    b, s = 2, 64
    u = _t(_u(cfg, b, s, 7) * 0.5)
    y_pre, (tail, st) = mamba.mamba_forward(p, u, cfg, return_state=True)
    (cs, cd), (ss, sd) = mamba.mamba_decode_cache_specs(cfg, b)
    conv, state = torch.zeros(cs, dtype=cd), torch.zeros(ss, dtype=sd)
    ys = []
    for t in range(s):
        y, conv, state = mamba.mamba_decode(p, u[:, t:t + 1], cfg, conv,
                                            state)
        ys.append(y)
    np.testing.assert_allclose(y_pre.numpy(), torch.cat(ys, 1).numpy(),
                               atol=2e-3)
    np.testing.assert_allclose(st.numpy(), state.numpy(), atol=2e-3)
    np.testing.assert_allclose(tail.numpy(), conv.numpy(), atol=1e-4)


# ----------------------------------------------------------------- model

@pytest.fixture(scope="module")
def model():
    """(ref cfg, ref api, ref params, port cfg, port api, port params),
    the reference's init jiggled, carried across."""
    jcfg, cfg = _cfg_pair()
    japi = j_build_model(jcfg)
    tree = _jiggle(jax.tree.map(np.asarray,
                                japi.init_params(jax.random.key(0))), 9)
    api = build_model(cfg, device="cpu")
    return (jcfg, japi, jax.tree.map(jnp.asarray, tree), cfg, api,
            params_from_reference(cfg, tree))


def _spy_scan(monkeypatch):
    calls = []
    real = mamba.ops.ssd_scan

    def spy(*a, **kw):
        calls.append(kw.get("force"))
        return real(*a, **kw)
    monkeypatch.setattr(mamba.ops, "ssd_scan", spy)
    return calls


@pytest.mark.parametrize("seq", [64, 256])
def test_prefill_matches_reference(model, monkeypatch, seq):
    jcfg, japi, jparams, cfg, api, params = model
    tok = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, seq))
    calls = _spy_scan(monkeypatch)
    out = api.prefill(params, {"tokens": _t(tok)})
    assert calls == [None] * cfg.n_layers
    ref = jax.jit(japi.prefill)(jparams,
                                {"tokens": jnp.asarray(tok, jnp.int32)})
    assert out.shape == (2, cfg.vocab_size) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LOGITS)


def test_prefill_force_torch_equals_default_on_cpu(model):
    *_, cfg, api, params = model
    tok = _t(np.random.default_rng(11).integers(0, cfg.vocab_size, (1, 64)))
    assert torch.equal(api.prefill(params, {"tokens": tok}),
                       api.prefill(params, {"tokens": tok}, force="torch"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        api.prefill(params, {"tokens": tok}, force="cuda")
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        api.prefill(params, {"tokens": tok[:, :40]})


def test_greedy_decode_matches_reference(model):
    """Eight decode steps from the same first tokens: logits in band, the
    same greedy tokens, and the same caches."""
    jcfg, japi, jparams, cfg, api, params = model
    b = 3
    jcache = japi.init_decode_cache(b, 16)
    cache = api.init_decode_cache(b, 16)
    jstep = jax.jit(japi.decode_step)
    tok = np.random.default_rng(12).integers(2, cfg.vocab_size, (b, 1))
    for pos in range(8):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok, jnp.int32),
                           jnp.int32(pos))
        logits, cache = api.decode_step(params, cache, _t(tok), pos)
        jl = np.asarray(jl)
        np.testing.assert_allclose(logits.numpy(), jl, **LOGITS)
        np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                      jl.argmax(-1))
        tok = jl.argmax(-1)[:, None]
    for name in ("conv", "state"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache["pos0"][name]),
                                   **LOGITS)


def test_decode_cache_matches_reference_specs(model):
    jcfg, japi, jparams, cfg, api, params = model
    specs = jtransformer.decode_cache_specs(jcfg, 3, 16)
    assert list(specs) == ["pos0"]             # one layer per group
    cache = api.init_decode_cache(3, 16)
    assert sorted(cache) == sorted(specs["pos0"])
    for name, spec in specs["pos0"].items():
        assert tuple(cache[name].shape) == spec.shape
        assert str(cache[name].dtype).split(".")[-1] == spec.dtype.name
        assert not cache[name].any()
    bf16 = build_model(cfg.with_overrides(dtype="bfloat16"), device="cpu")
    cache = bf16.init_decode_cache(2, 8)
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["state"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_reference_carries_mamba_leaves_exactly(dtype):
    """Every leaf, the f32 per-head ones of a bf16 model included, bit for
    bit; the port's own init has the same tree, shapes and dtypes."""
    jcfg, cfg = _cfg_pair(dtype=dtype)
    tree = _jiggle(jax.tree.map(np.asarray, j_build_model(jcfg).init_params(
        jax.random.key(2))), 13)
    params = params_from_reference(cfg, tree)
    ref = tree["groups"]["pos0"]
    for i, lp in enumerate(params["layers"]):
        assert sorted(lp) == sorted(ref)
        for k, v in ref["mamba"].items():
            got = lp["mamba"][k]
            want = np.asarray(v[i])
            assert str(got.dtype).split(".")[-1] == want.dtype.name, k
            bits = {2: (torch.int16, np.int16), 4: (torch.int32, np.int32)}[
                want.dtype.itemsize]
            np.testing.assert_array_equal(got.view(bits[0]).numpy(),
                                          want.view(bits[1]), err_msg=k)
    for k in ("dt_bias", "A_log", "D"):
        assert params["layers"][0]["mamba"][k].dtype == torch.float32
    own = build_model(cfg, device="cpu").init_params(0)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, params))
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(
        jax.tree.leaves(own), jax.tree.leaves(params)))


def test_serve_main_prints_the_reference_line(monkeypatch, capsys):
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--reduced"])
    jserve.main()
    ref_line = capsys.readouterr().out.strip().splitlines()[-1]
    pattern = re.compile(r"^mamba2-780m \(reduced\): [0-9.]+ tok/s "
                         r"\(batch 4, 32 steps, 1 device\(s\)\)$")
    assert pattern.match(port_line), port_line
    assert pattern.match(ref_line), ref_line
    assert res["steps"] == 31 and res["logits"].shape == (4, 512)
    assert bool(torch.isfinite(res["logits"]).all())
