"""Port parity: the MoE FFN (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``) on the CPU.

Both sides get the reference's ``init_moe`` draws and the same inputs,
made with numpy from a seed.  Bands (PERF.md "Parity bands"):
  no drops (capacity_factor 8)     atol 2e-4 against the reference and
                                   its dense top-k mixture (the
                                   reference's own band for it)
  drops (capacity_factor 1)        kept/dropped mask exact; outputs rtol
                                   1e-5, atol 1e-6
  bf16 combine                     bit-equal to the reference's
                                   scatter-add (XLA on the CPU adds a
                                   token's entries in ascending expert id)
  aux                              rtol 1e-6
  capacity                         equal
"""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e", "jamba-v0.1-52b")


def _t(a):
    return torch.from_numpy(np.array(a))


class _WideEinsum:
    """``jax.numpy`` whose ``einsum`` widens the operands of a product
    with an f32 result to f32 first: the same products (two bf16 values
    multiply exactly in f32) summed in f32."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) for o in ops]
        return jnp.einsum(spec, *ops,
                          preferred_element_type=preferred_element_type, **kw)


@contextlib.contextmanager
def wide_bf16_products():
    """XLA's CPU backend has no batched bf16 x bf16 -> f32 product
    ("Unsupported element type for DotThunk::Execute: BF16 x BF16 = F32"),
    so the reference's bf16 expert products cannot run on this CPU as
    written; inside this context its MoE module takes them widened."""
    real = jmoe.jnp
    jmoe.jnp = _WideEinsum()
    try:
        yield
    finally:
        jmoe.jnp = real


def _cfgs(arch, **moe_kw):
    jcfg = jconfigs.smoke_reduce(jconfigs.get_config(arch))
    cfg = configs.smoke_reduce(configs.get_config(arch))
    if moe_kw:
        jcfg = jcfg.with_overrides(moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **moe_kw))
    return jcfg, cfg


def _params(jcfg, seed=0, dtype=jnp.float32):
    return jax.tree.map(np.asarray, jmoe.init_moe(jcfg, jax.random.key(seed),
                                                  dtype))


def _run_both(jcfg, cfg, p, x):
    jout, jaux = jax.jit(lambda p_, x_: jmoe.apply_moe(p_, x_, jcfg))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    out, aux = moe.apply_moe({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    return out, aux, np.asarray(jout), np.asarray(jaux)


def _dense_ref(p, x, cfg):
    """The reference test's top-k mixture without capacity
    (``tests/test_moe_dispatch.py::dense_ref``)."""
    b, s, d = x.shape
    xf = jnp.asarray(x).reshape(-1, d)
    probs = jax.nn.softmax(xf @ p["router"], -1)
    gates, ids = jax.lax.top_k(probs, cfg.moe.top_k)
    gates = gates / gates.sum(-1, keepdims=True)
    out = jnp.zeros_like(xf)
    for kk in range(cfg.moe.top_k):
        for ei in range(cfg.moe.n_experts):
            mask = (ids[:, kk] == ei).astype(jnp.float32) * gates[:, kk]
            h = jax.nn.silu(xf @ p["wi"][ei]) * (xf @ p["wu"][ei])
            out += (h @ p["wo"][ei]) * mask[:, None]
    return np.asarray(out.reshape(b, s, d))


@pytest.mark.parametrize("dispatch", ["shard", "global"])
@pytest.mark.parametrize("arch", ARCHS)
def test_no_drops_matches_reference_and_dense(arch, dispatch):
    jcfg, cfg = _cfgs(arch, capacity_factor=8.0)
    jcfg = jcfg.with_overrides(moe_dispatch=dispatch)
    cfg = cfg.with_overrides(moe_dispatch=dispatch)
    p = _params(jcfg)
    x = np.random.default_rng(0).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    out, aux, jout, jaux = _run_both(jcfg, cfg, p, x)
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), jout, atol=2e-4)
    np.testing.assert_allclose(out.numpy(), _dense_ref(
        jax.tree.map(jnp.asarray, p), x, jcfg), atol=2e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def _skewed(cfg, seed):
    """A router that sends most tokens to experts 0 and 1, so that they
    overflow at capacity_factor 1."""
    jcfg = jconfigs.smoke_reduce(jconfigs.get_config("moonshot-v1-16b-a3b"))
    p = _params(jcfg.with_overrides(moe=dataclasses.replace(
        jcfg.moe, n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k)), seed)
    p["router"] = p["router"].copy()
    p["router"][:, :2] += 0.15
    return p


def _reference_keep(ids, cap, n_experts):
    """The reference's kept mask, in token-slot order, from its ids (the
    lines of ``repro/models/moe.py::apply_moe`` in numpy)."""
    flat = np.asarray(ids).reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=n_experts)
    starts = np.cumsum(counts) - counts
    pos = np.arange(flat.size) - starts[flat[order]]
    keep = np.empty(flat.size, bool)
    keep[order] = pos < cap
    return keep.reshape(ids.shape)


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_capacity_drops_match_reference(top_k):
    jcfg, cfg = _cfgs("moonshot-v1-16b-a3b", capacity_factor=1.0,
                      n_experts=8, top_k=top_k)
    p = _skewed(cfg, seed=top_k)
    x = np.random.default_rng(top_k).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32)
    t = x.shape[0] * x.shape[1]
    cap = moe.moe_capacity(t, cfg)
    assert cap == jmoe.moe_capacity(t, jcfg)
    xs = _t(x).reshape(t, -1)
    _, ids, _ = moe.route({k: _t(v) for k, v in p.items()}, xs, cfg)
    jprobs = jax.nn.softmax(jnp.asarray(x).reshape(t, -1) @ p["router"], -1)
    _, jids = jax.lax.top_k(jprobs, top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    order, keep, _ = moe.dispatch(ids, cap, cfg.moe.n_experts)
    port_keep = np.empty(t * top_k, bool)
    port_keep[order.numpy()] = keep.numpy()
    ref_keep = _reference_keep(np.asarray(jids), cap, cfg.moe.n_experts)
    assert (~ref_keep).sum() > 0                   # the router does overflow
    np.testing.assert_array_equal(port_keep.reshape(t, top_k), ref_keep)
    out, aux, jout, jaux = _run_both(jcfg, cfg, p, x)
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    # a token whose every entry dropped has a zero FFN output
    gone = ~ref_keep.any(-1)
    assert not out.numpy().reshape(t, -1)[gone].any()


def _combine_case(seed, t=64, k=4, n_experts=8, d=32):
    """Contributions that span 12 binades, so that adding a token's four
    in another order rounds otherwise in bf16."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(n_experts)[:k] for _ in range(t)])
    order = np.argsort(ids.reshape(-1), kind="stable")
    back = (rng.standard_normal((t * k, d))
            * np.exp(rng.uniform(-6, 6, (t * k, 1)))).astype(np.float32)
    back = np.asarray(jnp.asarray(back).astype(jnp.bfloat16))
    ref = jax.jit(lambda ti, bk: jnp.zeros((t, d), jnp.bfloat16)
                  .at[ti].add(bk))(jnp.asarray(order // k), jnp.asarray(back))
    bt = _t(back.astype(np.float32)).to(torch.bfloat16)
    return bt, torch.from_numpy(order), k, np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_combine_is_bit_equal_to_the_reference(seed):
    back, order, k, ref = _combine_case(seed)
    out = moe.combine(back, order, k)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), ref)


def test_bf16_combine_in_another_order_differs():
    """The mutation: the same adds in descending expert id (or in top-k
    slot order) miss the reference's bits, so the order is pinned."""
    back, order, k, ref = _combine_case(0)
    n = back.shape[0]
    where = torch.empty_like(order)
    where[order] = torch.arange(n)
    ascending = torch.sort(where.view(n // k, k), dim=1).values
    for slots in (ascending.flip(1), where.view(n // k, k)):
        out = torch.zeros((n // k, back.shape[1]), dtype=torch.bfloat16)
        for j in range(k):
            out = out + back[slots[:, j]]
        assert not np.array_equal(out.float().numpy(), ref)


def test_bf16_apply_moe_agrees_with_reference():
    """The whole layer in bf16 (router and expert products in f32, the
    rest in bf16): within 2 bf16 ulps of the largest output.  Measured:
    bit-equal on 99.98% of the elements, the largest difference 0.05 of
    one ulp of the largest output (f32 sums in another order move a few
    roundings)."""
    jcfg, cfg = _cfgs("moonshot-v1-16b-a3b", capacity_factor=8.0,
                      n_experts=8, top_k=4)
    jcfg, cfg = (c.with_overrides(dtype="bfloat16") for c in (jcfg, cfg))
    p = jax.tree.map(np.asarray, jmoe.init_moe(jcfg, jax.random.key(3),
                                               jnp.bfloat16))
    x = np.asarray(jnp.asarray(np.random.default_rng(3).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)).astype(jnp.bfloat16))
    with wide_bf16_products():
        jout, jaux = jax.jit(lambda p_, x_: jmoe.apply_moe(p_, x_, jcfg))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))

    def bf(a):
        return _t(np.asarray(a, np.float32)).to(torch.bfloat16) \
            if a.dtype != np.float32 else _t(a)
    out, aux = moe.apply_moe({k: bf(v) for k, v in p.items()}, bf(x), cfg)
    jout = np.asarray(jout.astype(jnp.float32))
    diff = np.abs(out.float().numpy() - jout)
    assert diff.max() <= 2 * 2.0 ** -7 * np.abs(jout).max()
    assert (diff == 0).mean() > 0.99
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_capacity_equals_reference(arch):
    for c in (jconfigs.get_config(arch), jconfigs.smoke_reduce(
            jconfigs.get_config(arch))):
        port = configs.get_config(arch) if c.d_model > 128 else \
            configs.smoke_reduce(configs.get_config(arch))
        for cf in (0.5, 1.0, 1.25, 8.0):
            jc = c.with_overrides(moe=dataclasses.replace(
                c.moe, capacity_factor=cf))
            pc = port.with_overrides(moe=dataclasses.replace(
                port.moe, capacity_factor=cf))
            for n in (1, 3, 4, 7, 64, 100, 1000, 2048, 8192, 32768):
                assert moe.moe_capacity(n, pc) == jmoe.moe_capacity(n, jc)


def test_init_moe_layout():
    cfg = configs.smoke_reduce(configs.get_config("moonshot-v1-16b-a3b"))
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(cfg, gen, torch.bfloat16)
    ref = jmoe.init_moe(jconfigs.smoke_reduce(jconfigs.get_config(
        "moonshot-v1-16b-a3b")), jax.random.key(0), jnp.bfloat16)
    for name, leaf in p.items():
        assert tuple(leaf.shape) == ref[name].shape
        assert str(leaf.dtype).split(".")[1] == str(ref[name].dtype)
        assert leaf.is_contiguous()
