"""Port parity: the LM stack's dense-decoder serving path
(``repro_torch.configs``, ``models``, ``convert``, ``launch.serve``)
against the reference's (``repro``) on the CPU.

Both sides get the same parameters (the reference's init, carried across
by ``params_from_reference``, with norm scales and QKV biases moved off
their constant init so that those terms are exercised) and the same
tokens, made with numpy from a seed.  Configs are ``smoke_reduce``d, f32,
with the flash branch on (``use_flash="auto"``) and two layers, so that a
2,048-token prefill takes it (the blocked plain version on the CPU).

Bands (PERF.md "Parity bands"):
  configs                      equal, field for field
  layer functions              rtol 1e-5, atol 1e-6 (f32; XLA and torch
                               sum products in other orders, and their
                               sin/cos/pow differ in the last bit:
                               6e-8 on the RoPE tables)
  prefill / decode logits      rtol 1e-5, atol 1e-5 (f32 logits of
                               magnitude <= 14; at most 4.7e-6 seen)
  greedy tokens                exact
"""

import dataclasses
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
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.utils import prng  # noqa: E402

ARCHS = ("tinyllama-1.1b", "qwen2-1.5b", "gemma-7b")
LOGITS = dict(rtol=1e-5, atol=1e-5)
LAYER = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_reference(arch):
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    ref, port = jconfigs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(configs.smoke_reduce(port))
            == dataclasses.asdict(jconfigs.smoke_reduce(ref)))
    for name, shape in configs.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jconfigs.SHAPES[name])
        assert (configs.shape_applicable(port, shape)
                == jconfigs.shape_applicable(ref, jconfigs.SHAPES[name]))
    assert port.resolved_head_dim() == ref.resolved_head_dim()
    assert port.attn_layer_ids() == ref.attn_layer_ids()


# ------------------------------------------------------------------- layers

def _cfg_pair(arch, **kw):
    ref = jconfigs.smoke_reduce(jconfigs.get_config(arch)).with_overrides(**kw)
    port = configs.smoke_reduce(configs.get_config(arch)).with_overrides(**kw)
    return ref, port


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 300, 4, 64)).astype(np.float32)
    pos = np.arange(300) * 7
    js, jc = jlayers.rope_angles(jnp.asarray(pos), 64, theta)
    s, c = layers.rope_angles(_t(pos), 64, theta)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **LAYER)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **LAYER)
    np.testing.assert_allclose(
        layers.apply_rope(_t(x), s, c).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), js, jc)), **LAYER)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-medium"])
def test_norm_matches_reference(arch):
    jcfg, cfg = _cfg_pair(arch)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, cfg.d_model)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32),
         "bias": rng.standard_normal(cfg.d_model).astype(np.float32)}
    if cfg.norm_type == "rmsnorm":
        del p["bias"]
    out = layers.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    ref = jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma-7b",
                                  "whisper-medium"])
def test_mlp_matches_reference(arch):
    """SwiGLU, GeGLU and the plain GELU MLP (with biases)."""
    jcfg, cfg = _cfg_pair(arch)
    p = jax.tree.map(np.asarray, jlayers.init_mlp(jcfg, jax.random.key(2),
                                                  jnp.float32))
    rng = np.random.default_rng(2)
    p = {k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
         for k, v in p.items()}
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    out = layers.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    ref = jlayers.apply_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma-7b"])
def test_embed_and_logits_match_reference(arch):
    """gemma scales embeddings by sqrt(d) and ties the head."""
    jcfg, cfg = _cfg_pair(arch)
    rng = np.random.default_rng(3)
    table = rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(
        np.float32)
    head = rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(
        np.float32)
    tok = rng.integers(0, cfg.vocab_size, (2, 9))
    x = layers.embed_tokens({"table": _t(table)}, _t(tok), cfg)
    jx = jlayers.embed_tokens({"table": jnp.asarray(table)},
                              jnp.asarray(tok), jcfg)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    hp = {} if cfg.tie_embeddings else {"w": _t(head)}
    jhp = {} if cfg.tie_embeddings else {"w": jnp.asarray(head)}
    # unit-normal tables: logits over d = 128 reach ~1,600 (gemma's
    # sqrt(d) scale included), so the absolute part of the band grows
    np.testing.assert_allclose(
        layers.lm_logits({"table": _t(table)}, hp, x, cfg).numpy(),
        np.asarray(jlayers.lm_logits({"table": jnp.asarray(table)}, jhp,
                                     jx, jcfg)), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_embed_scale_matches_reference(arch):
    """Every arch's token embedding (gemma's sqrt(d) scale or none) equals
    the reference's, at full size and at smoke size."""
    rng = np.random.default_rng(5)
    for jcfg, cfg in ((jconfigs.get_config(arch), configs.get_config(arch)),
                      _cfg_pair(arch)):
        table = rng.standard_normal((16, cfg.d_model)).astype(np.float32)
        tok = rng.integers(0, 16, (2, 5))
        np.testing.assert_array_equal(
            layers.embed_tokens({"table": _t(table)}, _t(tok), cfg).numpy(),
            np.asarray(jlayers.embed_tokens({"table": jnp.asarray(table)},
                                            jnp.asarray(tok), jcfg)))


@pytest.mark.parametrize("length", [None, 1, 37])
def test_decode_attention_matches_reference(length):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 1, 8, 32)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, 64, 2, 32)).astype(np.float32)
              for _ in range(2))
    out = attn.decode_attention(_t(q), _t(ck), _t(cv), length=length)
    ref = jattn.decode_attention(jnp.asarray(q), jnp.asarray(ck),
                                 jnp.asarray(cv), length=length)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER)


def test_dense_init_is_a_truncated_fan_in_normal():
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, 256, (64, 8), torch.bfloat16)
    assert w.shape == (256, 64, 8) and w.dtype == torch.bfloat16
    w = w.float()
    assert float(w.abs().max()) <= 2 * 256 ** -0.5
    # the unit normal truncated to (-2, 2) has std 0.8796
    assert abs(float(w.std()) / 256 ** -0.5 - 0.8796) < 0.02
    again = layers.dense_init(torch.Generator().manual_seed(0), 256, (64, 8),
                              torch.bfloat16)
    assert torch.equal(again.float(), w)


# -------------------------------------------------------------------- slice

@pytest.fixture(scope="module")
def models():
    """arch -> (ref cfg, ref api, ref params, port cfg, port api, port
    params), built once per module: 2 layers, flash branch on."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, cfg = _cfg_pair(arch, n_layers=2, use_flash="auto")
            japi = j_build_model(jcfg)
            tree = jax.tree.map(np.asarray,
                                japi.init_params(jax.random.key(0)))
            rng = np.random.default_rng(5)

            def jiggle(path, a):
                name = jax.tree_util.keystr(path)
                if "scale" in name or re.search(r"'b[qkv]'", name):
                    return a + 0.1 * rng.standard_normal(a.shape).astype(
                        a.dtype)
                return a
            tree = jax.tree_util.tree_map_with_path(jiggle, tree)
            api = build_model(cfg, device="cpu")
            cache[arch] = (jcfg, japi, jax.tree.map(jnp.asarray, tree), cfg,
                           api, params_from_reference(cfg, tree))
        return cache[arch]
    return get


def _spy_flash(monkeypatch):
    calls = []
    real = attn.ops.flash_attention

    def spy(*a, **kw):
        calls.append(kw.get("force"))
        return real(*a, **kw)
    monkeypatch.setattr(attn.ops, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("seq", [64, 2048])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(models, monkeypatch, arch, seq):
    """64 tokens take ``plain_attention``, 2,048 the flash branch (once
    per layer), as the reference's rule says."""
    jcfg, japi, jparams, cfg, api, params = models(arch)
    tok = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, seq))
    calls = _spy_flash(monkeypatch)
    out = api.prefill(params, {"tokens": _t(tok)})
    assert calls == ([None] * cfg.n_layers if seq >= 2048 else [])
    ref = jax.jit(japi.prefill)(jparams, {"tokens": jnp.asarray(tok, jnp.int32)})
    assert out.shape == (2, cfg.vocab_size) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LOGITS)


def test_prefill_force_torch_equals_default_on_cpu(models):
    *_, cfg, api, params = models("tinyllama-1.1b")
    tok = _t(np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 2048)))
    assert torch.equal(api.prefill(params, {"tokens": tok}),
                       api.prefill(params, {"tokens": tok}, force="torch"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        api.prefill(params, {"tokens": tok}, force="cuda")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_reference(models, arch):
    """Eight decode steps from the same first tokens: logits in band and
    the same greedy tokens at every step."""
    jcfg, japi, jparams, cfg, api, params = models(arch)
    b, max_seq = 3, 16
    jcache = japi.init_decode_cache(b, max_seq)
    cache = api.init_decode_cache(b, max_seq)
    assert cache["k"].shape == (cfg.n_layers, b, max_seq, cfg.n_kv_heads,
                                cfg.resolved_head_dim())
    jstep = jax.jit(japi.decode_step)
    tok = np.random.default_rng(8).integers(2, cfg.vocab_size, (b, 1))
    for pos in range(8):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok, jnp.int32),
                           jnp.int32(pos))
        logits, cache = api.decode_step(params, cache, _t(tok), pos)
        jl = np.asarray(jl)
        np.testing.assert_allclose(logits.numpy(), jl, **LOGITS)
        np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                      jl.argmax(-1))
        tok = jl.argmax(-1)[:, None]
    np.testing.assert_allclose(cache["k"][:, :, :8].numpy(),
                               np.asarray(jcache["pos0"]["k"][:, :, :8]),
                               **LOGITS)
    assert not cache["k"][:, :, 8:].any()


def test_params_from_reference_carries_values_exactly(models):
    jcfg, japi, jparams, cfg, api, params = models("qwen2-1.5b")
    assert len(params["layers"]) == cfg.n_layers
    assert params["head"] == {}                  # tied embeddings
    for i, lp in enumerate(params["layers"]):
        ref = jparams["groups"]["pos0"]
        np.testing.assert_array_equal(lp["attn"]["wq"].numpy(),
                                      np.asarray(ref["attn"]["wq"][i]))
        np.testing.assert_array_equal(lp["attn"]["bk"].numpy(),
                                      np.asarray(ref["attn"]["bk"][i]))
        np.testing.assert_array_equal(lp["mlp"]["wo"].numpy(),
                                      np.asarray(ref["mlp"]["wo"][i]))
    own = api.init_params(0)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, params))
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(
        jax.tree.leaves(own), jax.tree.leaves(params)))


# -------------------------------------------------------------- entry point

def test_first_token_is_the_reference_draw():
    tok = prng.randint(prng.key(0), (4, 1), 2, 512)
    ref = jax.random.randint(jax.random.key(0), (4, 1), 2, 512, jnp.int32)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref))


def test_serve_main_prints_the_reference_line(monkeypatch, capsys):
    res = serve.main(["--arch", "tinyllama-1.1b", "--reduced", "--device",
                      "cpu"])
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "tinyllama-1.1b",
                                      "--reduced"])
    jserve.main()
    ref_line = capsys.readouterr().out.strip().splitlines()[-1]
    pattern = re.compile(r"^tinyllama-1\.1b \(reduced\): [0-9.]+ tok/s "
                         r"\(batch 4, 32 steps, 1 device\(s\)\)$")
    assert pattern.match(port_line), port_line
    assert pattern.match(ref_line), ref_line
    assert res["steps"] == 31 and res["logits"].shape == (4, 512)
    assert bool(torch.isfinite(res["logits"]).all())
