"""Port parity: per-data-shard MoE dispatch (``repro_torch.models.moe``
under ``sharding.use_rules``) against the reference's under its
``_state.rules = {"dp_shards": S}`` emulation
(``tests/test_moe_dispatch.py:68-73``), on the CPU in f32.

Bands (PERF.md "Parity bands"): top-k ids and kept mask per shard exact;
outputs rtol 1e-5, atol 1e-6 (``tests/test_torch_moe.py``'s band); aux
rtol 1e-6.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.sharding import ctx as jctx  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.sharding import use_rules  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _threads():
    """Two intra-op threads: the tier-1 run uses six workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


ARCH = "moonshot-v1-16b-a3b"
B, S_LEN = 4, 24


@contextlib.contextmanager
def _reference_shards(n):
    """The reference's emulation of ``dp_shards`` without a mesh."""
    jctx._state.rules, jctx._state.mesh = {"dp_shards": n}, None
    try:
        yield
    finally:
        jctx._state.rules = None


def _cfgs(cf, **kw):
    jcfg = jconfigs.smoke_reduce(jconfigs.get_config(ARCH))
    cfg = configs.smoke_reduce(configs.get_config(ARCH))
    over = dict(moe=dataclasses.replace(cfg.moe, capacity_factor=cf), **kw)
    jover = dict(moe=dataclasses.replace(jcfg.moe, capacity_factor=cf), **kw)
    return jcfg.with_overrides(**jover), cfg.with_overrides(**over)


def _case(jcfg, seed=0, skew=True):
    """Reference init (a router skewed to experts 0 and 1 so that they
    overflow at capacity_factor 1) and a seeded input."""
    p = jax.tree.map(np.asarray, jmoe.init_moe(jcfg, jax.random.key(seed),
                                               jnp.float32))
    if skew:
        p["router"] = p["router"].copy()
        p["router"][:, :2] += 0.15
    x = np.random.default_rng(seed).standard_normal(
        (B, S_LEN, jcfg.d_model)).astype(np.float32)
    return p, x


def _reference(jcfg, p, x, n):
    with _reference_shards(n):
        out, aux = jax.jit(lambda p_, x_: jmoe.apply_moe(p_, x_, jcfg))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    return np.asarray(out), float(aux)


def _reference_routing(jcfg, p, x, n):
    """The reference's per-shard ids [S, T, k] and kept mask [S, T, k] in
    token-slot order (the lines of ``repro/models/moe.py::apply_moe`` in
    numpy)."""
    e, k = jcfg.moe.n_experts, jcfg.moe.top_k
    t = x.shape[0] // n * x.shape[1]
    cap = jmoe.moe_capacity(t, jcfg)
    xs = jnp.asarray(x).reshape(n, t, -1)
    probs = jax.nn.softmax(jnp.einsum("std,de->ste", xs, p["router"]), -1)
    ids = np.asarray(jax.lax.top_k(probs, k)[1])
    keep = np.empty((n, t * k), bool)
    for i in range(n):
        flat = ids[i].reshape(-1)
        order = np.argsort(flat, kind="stable")
        counts = np.bincount(flat, minlength=e)
        starts = np.cumsum(counts) - counts
        keep[i, order] = (np.arange(flat.size) - starts[flat[order]]) < cap
    return ids, keep.reshape(n, t, k)


def _port(cfg, p, x, n):
    """(out, aux, ids [S, T, k], keep [S, T, k]) of the port under
    ``dp_shards`` n, the routing recorded from its ``route`` / ``dispatch``
    calls."""
    rec = {}
    real_route, real_dispatch = moe.route, moe.dispatch

    def route(*a):
        rec["route"] = real_route(*a)
        return rec["route"]

    def dispatch(*a):
        rec["dispatch"] = real_dispatch(*a)
        return rec["dispatch"]
    moe.route, moe.dispatch = route, dispatch
    try:
        with use_rules(None, {"dp_shards": n}):
            out, aux = moe.apply_moe({k: torch.from_numpy(v.copy())
                                      for k, v in p.items()},
                                     torch.from_numpy(x), cfg)
    finally:
        moe.route, moe.dispatch = real_route, real_dispatch
    ids = rec["route"][1]
    order, keep_sorted, _ = rec["dispatch"]
    keep = torch.empty_like(keep_sorted)
    keep.scatter_(-1, order, keep_sorted)
    return out, float(aux), ids.numpy(), keep.reshape(ids.shape).numpy()


@pytest.mark.parametrize("cf", [1.0, 8.0])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_per_shard_dispatch_matches_reference(n, cf):
    jcfg, cfg = _cfgs(cf)
    p, x = _case(jcfg)
    jout, jaux = _reference(jcfg, p, x, n)
    out, aux, ids, keep = _port(cfg, p, x, n)
    jids, jkeep = _reference_routing(jcfg, p, x, n)
    assert ids.shape == jids.shape == (n, B // n * S_LEN, cfg.moe.top_k)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(keep, jkeep)
    if cf == 1.0:
        assert (~keep).sum() > 0                  # the router overflows
    else:
        assert keep.all()
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)


def test_shard_count_changes_the_drops():
    """At capacity_factor 1 the shard count is not a detail: one global
    bucket (a port that ignored the rules) drops other entries and gives
    another output than the reference's per-shard run, beyond the
    band."""
    jcfg, cfg = _cfgs(1.0)
    p, x = _case(jcfg)
    jout, _ = _reference(jcfg, p, x, 4)
    _, jkeep4 = _reference_routing(jcfg, p, x, 4)
    _, jkeep1 = _reference_routing(jcfg, p, x, 1)
    assert not np.array_equal(jkeep4.reshape(-1), jkeep1.reshape(-1))
    one, _, _, _ = _port(cfg, p, x, 1)
    gl, _, _, keep = _port(cfg.with_overrides(moe_dispatch="global"), p, x,
                           4)
    assert torch.equal(one, gl) and keep.shape[0] == 1
    assert not np.allclose(one.numpy(), jout, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [3, 8])
def test_shards_that_do_not_divide_the_batch_fall_back_to_one(n):
    jcfg, cfg = _cfgs(1.0)
    p, x = _case(jcfg)
    jout, jaux = _reference(jcfg, p, x, n)
    out, aux, ids, _ = _port(cfg, p, x, n)
    base, base_aux, _, _ = _port(cfg, p, x, 1)
    assert ids.shape[0] == 1
    assert torch.equal(out, base) and aux == base_aux
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)


def test_train_loss_under_rules_matches_reference():
    """The model's ``train_loss`` with two dispatch shards: every MoE layer
    buckets per shard, in both packages (loss and aux rtol 1e-5, the
    training band)."""
    from repro.data import host_batch
    from repro_torch.configs.base import ShapeConfig
    jcfg, cfg = _cfgs(1.0, n_layers=1)
    shape = ShapeConfig("t", seq_len=32, global_batch=4, kind="train")
    tree = jax.tree.map(np.asarray, jax.jit(j_build_model(jcfg).init_params)(
        jax.random.key(0)))
    hb = host_batch(jcfg, shape, 0)
    with _reference_shards(2):
        jloss, jm = jax.jit(j_build_model(jcfg).train_loss)(
            jax.tree.map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in hb.items()})
    api = build_model(cfg, device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in hb.items()}
    params = params_from_reference(cfg, tree)
    with use_rules(None, {"dp_shards": 2}):
        loss, m = api.train_loss(params, batch)
    one, m1 = api.train_loss(params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5)
    assert float(m["aux"]) != float(m1["aux"])
