"""Port parity: the families the last serving slice added -- MoE
(llama4-scout, moonshot), the Jamba hybrid, the Whisper encoder-decoder
and the phi-3-vision prefix (``repro_torch.models``, ``convert``) --
against the reference's (``repro``) on the CPU, and the bf16 smoke
prefill and decode of every registry family.

Both sides get the reference's init, carried across by
``params_from_reference``, with the norm scales and biases, the MLP
biases and Jamba's per-head SSD leaves moved off their constant init, and
the same inputs made with numpy from a seed.  Configs are
``smoke_reduce``d, f32, with the flash branch on (``use_flash="auto"``):
2 layers (8 for Jamba, one group: attention at layer 3, MoE at the odd
layers), so that 2,048 positions take the flash branch (the blocked
plain version on the CPU).

Bands (PERF.md "Parity bands"):
  prefill / decode logits (f32)   rtol 1e-5, atol 5e-5, as for mamba2
                                  in tests/test_torch_mamba.py (at most
                                  2.7e-5 seen, moonshot's 2,048-position
                                  prefill, logits up to 3.6)
  greedy tokens                   exact
  params_from_reference           exact, bit for bit
  filled cross-attention memory   rtol 1e-5, atol 1e-6
  teacher-forced decode vs the    the same band (Jamba: the chunked scan
  port's own prefill (f32)        against the recurrence, 1.2e-5 seen;
                                  Whisper 4.8e-7)
  bf16 smoke prefill and decode   per family, from the reference's own
                                  bf16 run against its f32 run
                                  (``BF16_BANDS``: floor, band)
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

from test_torch_moe import wide_bf16_products  # noqa: E402

FAMILIES = ("llama4-scout-17b-a16e", "moonshot-v1-16b-a3b",
            "jamba-v0.1-52b", "whisper-medium", "phi-3-vision-4.2b")
LOGITS = dict(rtol=1e-5, atol=5e-5)
_JIGGLE = re.compile(r"scale|bias|'b[qkvio]'|A_log|conv_b|\['D'\]")


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfg_pair(arch, **kw):
    layers = 8 if arch.startswith("jamba") else 2
    kw = {"n_layers": layers, "use_flash": "auto", **kw}
    ref = jconfigs.smoke_reduce(jconfigs.get_config(arch)).with_overrides(**kw)
    port = configs.smoke_reduce(configs.get_config(arch)).with_overrides(**kw)
    return ref, port


def _jiggle(tree, seed):
    rng = np.random.default_rng(seed)

    def move(path, a):
        if _JIGGLE.search(jax.tree_util.keystr(path)):
            return a + (0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(move, tree)


def _build(arch, **kw):
    """(ref cfg, ref api, ref params (jnp), port cfg, port api, port
    params, numpy tree)."""
    jcfg, cfg = _cfg_pair(arch, **kw)
    japi = j_build_model(jcfg)
    tree = _jiggle(jax.tree.map(np.asarray,
                                japi.init_params(jax.random.key(0))), 11)
    api = build_model(cfg, device="cpu")
    return (jcfg, japi, jax.tree.map(jnp.asarray, tree), cfg, api,
            params_from_reference(cfg, tree), tree)


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _build(arch)
        return cache[arch]
    return get


def _batch(cfg, seq, seed, b=2):
    """A prefill batch of ``seq`` positions: tokens, and Whisper's frames
    or phi-3's patches (which count towards the positions) from numpy."""
    rng = np.random.default_rng(seed)
    n_tok = seq - (cfg.n_patches if cfg.frontend == "vision" else 0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, n_tok))}
    if cfg.is_encoder_decoder:
        batch["frame_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def _port_batch(batch, dtype=torch.float32):
    return {k: _t(v) if k == "tokens" else _t(v).to(dtype)
            for k, v in batch.items()}


def _ref_batch(batch, dtype=jnp.float32):
    return {k: jnp.asarray(v, jnp.int32) if k == "tokens"
            else jnp.asarray(v).astype(dtype) for k, v in batch.items()}


def _spy_flash(monkeypatch):
    calls = []
    real = attn.ops.flash_attention

    def spy(*a, **kw):
        calls.append((kw.get("causal"), a[0].shape[1], a[1].shape[1]))
        return real(*a, **kw)
    monkeypatch.setattr(attn.ops, "flash_attention", spy)
    return calls


def _n_attention_layers(cfg):
    if cfg.is_encoder_decoder:
        return cfg.n_layers                       # the decoder's self-attention
    return len(cfg.attn_layer_ids())


@pytest.mark.parametrize("seq", [64, 2048])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_matches_reference(models, monkeypatch, arch, seq):
    """64 positions take ``plain_attention``; 2,048 take the flash branch
    once per attention layer (causal self-attention; Whisper's encoder
    and cross-attention over 16 frames stay plain)."""
    jcfg, japi, jparams, cfg, api, params, _ = models(arch)
    batch = _batch(cfg, seq, 6)
    calls = _spy_flash(monkeypatch)
    out = api.prefill(params, _port_batch(batch))
    n_flash = _n_attention_layers(cfg) if seq >= 2048 else 0
    assert calls == [(True, seq, seq)] * n_flash
    ref = jax.jit(japi.prefill)(jparams, _ref_batch(batch))
    assert out.shape == (2, cfg.vocab_size) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LOGITS)


def _fill_memory(cfg, params, jcfg, jparams, frames, cache, jcache):
    """The cross-attention memory from ``encode``'s output through each
    decoder layer's ``xattn`` K/V projection, on both sides."""
    from repro.models import encdec as jencdec
    from repro_torch.models import encdec
    enc = encdec.encode(cfg, params, _t(frames))
    jenc = jencdec.encode(jcfg, jparams, jnp.asarray(frames))
    jk, jv = [], []
    for i, lp in enumerate(params["dec_layers"]):
        _, (k, v) = attn.attn_forward(lp["xattn"], enc, cfg, causal=False,
                                      use_rope=False, kv_x=enc,
                                      return_kv=True)
        cache["mem_k"][i], cache["mem_v"][i] = k, v
        jlp = jax.tree.map(lambda a: a[i], jparams["dec_layers"])
        _, (k, v) = jattn.attn_forward(jlp["xattn"], jenc, jcfg, causal=False,
                                       use_rope=False, kv_x=jenc,
                                       return_kv=True)
        jk.append(k)
        jv.append(v)
    jcache = dict(jcache, mem_k=jnp.stack(jk), mem_v=jnp.stack(jv))
    for name in ("mem_k", "mem_v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=1e-5,
                                   atol=1e-6)
    assert cache["mem_k"].abs().max() > 0
    return cache, jcache


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_decode_matches_reference(models, arch):
    """Eight decode steps from the same first tokens: logits in band, the
    same greedy tokens at every step, and the caches alike (Whisper with
    its cross-attention memory filled from ``encode``)."""
    jcfg, japi, jparams, cfg, api, params, _ = models(arch)
    b, max_seq = 3, 16
    jcache = japi.init_decode_cache(b, max_seq)
    cache = api.init_decode_cache(b, max_seq)
    if cfg.is_encoder_decoder:
        frames = _batch(cfg, 8, 7, b)["frame_embeds"]
        cache, jcache = _fill_memory(cfg, params, jcfg, jparams, frames,
                                     cache, jcache)
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
    if cfg.is_encoder_decoder:
        pairs = [("self_k", jcache["self_k"])]
    else:
        attn_j = [j for j in range(transformer.group_size(cfg))
                  if cfg.layer_is_attn(j)]
        pairs = [("k", jnp.concatenate([jcache[f"pos{j}"]["k"]
                                        for j in attn_j]))]
    for name, ref in pairs:
        np.testing.assert_allclose(cache[name][:, :, :8].numpy(),
                                   np.asarray(ref[:, :, :8]), **LOGITS)
        assert not cache[name][:, :, 8:].any()


def test_hybrid_cache_holds_each_layer_kind(models):
    """Jamba's group: K/V for its one attention layer, conv and state for
    the seven Mamba-2 layers, and nothing else; after decoding, each row
    equals the reference's cache of the same layer."""
    jcfg, japi, jparams, cfg, api, params, _ = models("jamba-v0.1-52b")
    b, max_seq = 2, 8
    cache = api.init_decode_cache(b, max_seq)
    kinds = ["attn" if cfg.layer_is_attn(i) else "mamba"
             for i in range(cfg.n_layers)]
    assert kinds.count("attn") == 1 and kinds[3] == "attn"
    assert set(cache) == {"k", "v", "conv", "state"}
    assert cache["k"].shape == (1, b, max_seq, cfg.n_kv_heads,
                                cfg.resolved_head_dim())
    assert cache["conv"].shape[0] == cache["state"].shape[0] == 7
    assert transformer.cache_slots(cfg) == [0, 1, 2, 0, 3, 4, 5, 6]
    dense = build_model(configs.smoke_reduce(configs.get_config(
        "tinyllama-1.1b")), device="cpu").init_decode_cache(b, max_seq)
    ssm = build_model(configs.smoke_reduce(configs.get_config(
        "mamba2-780m")), device="cpu").init_decode_cache(b, max_seq)
    assert set(dense) == {"k", "v"} and set(ssm) == {"conv", "state"}

    jcache = japi.init_decode_cache(b, max_seq)
    tok = np.random.default_rng(9).integers(2, cfg.vocab_size, (b, 1))
    for pos in range(3):
        _, jcache = jax.jit(japi.decode_step)(
            jparams, jcache, jnp.asarray(tok, jnp.int32), jnp.int32(pos))
        _, cache = api.decode_step(params, cache, _t(tok), pos)
    for i, j in enumerate(transformer.cache_slots(cfg)):
        ref = jcache[f"pos{i}"]
        for name in (("k", "v") if kinds[i] == "attn" else ("conv", "state")):
            np.testing.assert_allclose(cache[name][j].numpy(),
                                       np.asarray(ref[name][0]), **LOGITS)


def _teacher_forced(api, params, cache, tokens):
    """Decode ``tokens`` [b, n] one position at a time; the last logits."""
    for pos in range(tokens.shape[1]):
        logits, cache = api.decode_step(params, cache, tokens[:, pos:pos + 1],
                                        pos)
    return logits


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-medium"])
def test_teacher_forced_decode_equals_prefill(arch):
    """Decoding the first 32 and 64 prompt tokens one at a time gives the
    prefill's last logits for those tokens (capacity_factor 8: no token
    drops in the 64-token prefill nor in a one-token decode step)."""
    import dataclasses
    jcfg, cfg = _cfg_pair(arch)
    if cfg.moe.n_experts:
        cfg = cfg.with_overrides(moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
        jcfg = jcfg.with_overrides(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=8.0))
    tree = _jiggle(jax.tree.map(np.asarray, j_build_model(jcfg).init_params(
        jax.random.key(0))), 11)
    api = build_model(cfg, device="cpu")
    params = params_from_reference(cfg, tree)
    batch = _port_batch(_batch(cfg, 64, 12))
    for n in (32, 64):
        pre = api.prefill(params, {**batch, "tokens": batch["tokens"][:, :n]})
        cache = api.init_decode_cache(2, 64)
        if cfg.is_encoder_decoder:
            from repro_torch.models import encdec
            enc = encdec.encode(cfg, params, batch["frame_embeds"])
            for i, lp in enumerate(params["dec_layers"]):
                _, (k, v) = attn.attn_forward(
                    lp["xattn"], enc, cfg, causal=False, use_rope=False,
                    kv_x=enc, return_kv=True)
                cache["mem_k"][i], cache["mem_v"][i] = k, v
        dec = _teacher_forced(api, params, cache, batch["tokens"][:, :n])
        np.testing.assert_allclose(dec.numpy(), pre.numpy(), **LOGITS)
        np.testing.assert_array_equal(dec.argmax(-1).numpy(),
                                      pre.argmax(-1).numpy())


def _ref_leaves(cfg, tree):
    """(port path, reference array) for every leaf of the reference's
    tree, the stacked layers split as the port lists them."""
    out = []

    def walk(node, path, index=None):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,), index)
        else:
            out.append((path, np.asarray(node if index is None
                                         else node[index])))
    for key, node in tree.items():
        if key == "groups":
            g = transformer.group_size(cfg)
            for gi in range(transformer.n_groups(cfg)):
                for j in range(g):
                    walk(node[f"pos{j}"], ("layers", gi * g + j), gi)
        elif key in ("enc_layers", "dec_layers"):
            n = cfg.n_encoder_layers if key == "enc_layers" else cfg.n_layers
            for i in range(n):
                walk(node, (key, i), i)
        else:
            walk(node, (key,))
    return out


def _get(params, path):
    for p in path:
        params = params[p]
    return params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_reference_carries_every_leaf_exactly(arch, dtype):
    jcfg, cfg = _cfg_pair(arch, dtype=dtype)
    tree = jax.tree.map(np.asarray, j_build_model(jcfg).init_params(
        jax.random.key(1)))
    params = params_from_reference(cfg, tree)
    leaves = _ref_leaves(cfg, tree)
    assert len(leaves) == len(jax.tree.leaves(params))
    for path, ref in leaves:
        got = _get(params, path)
        assert str(got.dtype).split(".")[1] == str(ref.dtype), path
        np.testing.assert_array_equal(
            got.float().numpy() if dtype == "bfloat16" else got.numpy(),
            ref.astype(np.float32))
    own = build_model(cfg, device="cpu").init_params(0)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, params))
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(
        jax.tree.leaves(own), jax.tree.leaves(params)))


# ------------------------------------------------------ bf16, every family

#: arch -> (floor, band): floor = max |reference bf16 logits - reference
#: f32 logits| over the smoke prefill (64 positions) and 4 decode steps,
#: the f32 run on the same bf16-valued weights (measured on this CPU,
#: rounded up); band = twice the floor: the port's bf16 run against the
#: reference's may differ by as much as either does from f32 (measured:
#: 0.79-1.26 x the floor)
BF16_BANDS = {
    "llama4-scout-17b-a16e": (0.029, 0.058),
    "moonshot-v1-16b-a3b": (0.029, 0.058),
    "jamba-v0.1-52b": (0.55, 1.1),
    "gemma-7b": (0.029, 0.058),
    "qwen2-1.5b": (0.034, 0.068),
    "internlm2-20b": (0.038, 0.076),
    "tinyllama-1.1b": (0.033, 0.066),
    "mamba2-780m": (0.069, 0.14),
    "whisper-medium": (0.026, 0.052),
    "phi-3-vision-4.2b": (0.034, 0.068),
}


def _bf16_runs(arch):
    """The bf16 smoke prefill (64 positions) and 4 decode steps of the
    reference, the port, and the reference in f32 on the same
    (bf16-valued) weights; the decode steps all feed the reference bf16
    run's greedy tokens.  Returns three lists of [b, V] f32 arrays
    (prefill, then each decode step)."""
    jcfg, cfg = _cfg_pair(arch, n_layers=configs.smoke_reduce(
        configs.get_config(arch)).n_layers, use_flash="never",
        dtype="bfloat16")
    tree = _jiggle(jax.tree.map(np.asarray, j_build_model(jcfg).init_params(
        jax.random.key(0))), 13)
    api = build_model(cfg, device="cpu")
    params = params_from_reference(cfg, tree)
    batch = _batch(cfg, 64, 14)
    b = batch["tokens"].shape[0]
    first = np.random.default_rng(15).integers(2, cfg.vocab_size, (b, 1))

    def reference(dtype, tokens):
        c = jcfg.with_overrides(dtype=dtype)
        japi = j_build_model(c)
        p = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)
        with wide_bf16_products():
            out = [np.asarray(jax.jit(japi.prefill)(
                p, _ref_batch(batch, jnp.dtype(dtype))))]
            cache, tok = japi.init_decode_cache(b, 8), first
            step = jax.jit(japi.decode_step)
            for pos in range(4):
                lg, cache = step(p, cache, jnp.asarray(tok, jnp.int32),
                                 jnp.int32(pos))
                out.append(np.asarray(lg))
                tok = (out[-1].argmax(-1)[:, None] if tokens is None
                       else tokens[pos])
        return out

    ref = reference("bfloat16", None)
    tokens = [r.argmax(-1)[:, None] for r in ref[1:]]
    ref32 = reference("float32", tokens)
    port = [api.prefill(params, _port_batch(batch, torch.bfloat16)).numpy()]
    cache, tok = api.init_decode_cache(b, 8), first
    for pos in range(4):
        lg, cache = api.decode_step(params, cache, _t(tok), pos)
        port.append(lg.numpy())
        tok = tokens[pos]
    return port, ref, ref32


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_bf16_prefill_and_decode_match_reference(arch):
    """The port's bf16 run against the reference's: logits within the
    family's band, greedy tokens equal where the reference's top-2 margin
    exceeds the band."""
    port, ref, ref32 = _bf16_runs(arch)
    floor, band = BF16_BANDS[arch]
    measured_floor = max(float(np.abs(r - f).max())
                         for r, f in zip(ref, ref32))
    diff = max(float(np.abs(p - r).max()) for p, r in zip(port, ref))
    print(f"{arch}: floor {measured_floor!r}, port vs ref {diff!r}")
    assert diff <= band, (arch, diff, band, measured_floor)
    for p, r in zip(port, ref):
        top2 = np.sort(r, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > band
        np.testing.assert_array_equal(p.argmax(-1)[clear], r.argmax(-1)[clear])
