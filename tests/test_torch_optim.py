"""Port parity: AdamW with f32 masters (``repro_torch.optim``) against the
reference's (``repro.optim``), jitted as its training step runs it, on
the CPU.

Bands:
  lr_schedule, steps 0-12 and 0-105     exact (the port takes XLA's
                                        reciprocal multiplies, folded
                                        constants and fused multiply-add;
                                        the cosine rounded once from f64;
                                        over 1,903 steps of eight configs
                                        one step differs, by 1 ulp, where
                                        XLA's cosine is not correctly
                                        rounded: that step is held to 1 ulp)
  adamw_update, unclipped: master, m,   exact, bit for bit (the moments
  v, lr, new params (f32 and bf16)      and the step are fused
                                        multiply-adds, the square root and
                                        b ** t correctly rounded)
  grad_norm                             rtol 1e-6 (the leaves' sums of
                                        squares are added in another order:
                                        the reference's leaves are stacked
                                        over the layer groups)
  adamw_update, clipped                 the clip scale follows grad_norm's
                                        last bit: m, v within 1e-6 x the
                                        leaf's max |.| (2.3e-7 seen); master
                                        within 2e-3 x lr_peak (0.6e-3 seen:
                                        Adam's normalised step magnifies
                                        an ulp of a moment that cancels)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.convert import (opt_state_from_reference,  # noqa: E402
                                 params_from_reference)
from repro_torch.utils.tree import flatten_with_names  # noqa: E402


def _ulps(a, b):
    a = np.asarray(a, np.float32).reshape(-1).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).reshape(-1).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("ocfg,steps,ulps", [
    (dict(lr_peak=3e-4, warmup_steps=2, total_steps=12), 13, 0),
    (dict(lr_peak=1e-3, warmup_steps=10, total_steps=100), 106, 1),
    (dict(lr_peak=0.1, warmup_steps=0, total_steps=10), 13, 0)])
def test_lr_schedule_matches_jitted_reference(ocfg, steps, ulps):
    jc, c = joptim.AdamWConfig(**ocfg), optim.AdamWConfig(**ocfg)
    f = jax.jit(lambda s: joptim.lr_schedule(jc, s))
    ref = np.array([f(jnp.int32(s)) for s in range(steps)], np.float32)
    mine = np.array([optim.lr_schedule(c, s).item() for s in range(steps)],
                    np.float32)
    assert _ulps(ref, mine) <= ulps
    step_t = torch.tensor(5, dtype=torch.int32)
    assert optim.lr_schedule(c, step_t).dtype == torch.float32


def _model_trees(arch, dtype, seed):
    """The reference's smoke params of ``arch`` in ``dtype`` (numpy), an
    AdamW state over them mid-run and gradients of the same layout."""
    jcfg = jconfigs.smoke_reduce(jconfigs.get_config(arch)).with_overrides(
        dtype=dtype)
    tree = jax.tree.map(np.asarray, j_build_model(jcfg).init_params(
        jax.random.key(seed)))
    rng = np.random.default_rng(seed)

    def like(scale, absval=False):
        def draw(x):
            a = rng.standard_normal(x.shape).astype(np.float32) * scale
            return np.abs(a) if absval else a
        return jax.tree.map(draw, tree)
    opt = {"master": jax.tree.map(lambda x: np.asarray(x, np.float32), tree),
           "m": like(1e-3), "v": like(1e-6, absval=True),
           "step": np.int32(4)}
    grads = jax.tree.map(lambda g, p: g.astype(p.dtype), like(1e-3), tree)
    return tree, opt, grads


@pytest.mark.parametrize("dtype,clip", [("float32", 1.0), ("float32", 0.05),
                                        ("bfloat16", 1.0)])
def test_adamw_update_is_the_reference_bit_for_bit(dtype, clip):
    arch = "qwen2-1.5b"
    cfg = configs.smoke_reduce(configs.get_config(arch)).with_overrides(
        dtype=dtype)
    tree, opt, grads = _model_trees(arch, dtype, 3)
    jc = joptim.AdamWConfig(lr_peak=3e-4, warmup_steps=2, total_steps=12,
                            clip_norm=clip)
    c = optim.AdamWConfig(lr_peak=3e-4, warmup_steps=2, total_steps=12,
                          clip_norm=clip)
    jdt = jnp.dtype(dtype)
    jp, jst, jm = jax.jit(lambda g, o: joptim.adamw_update(g, o, jc, jdt))(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, opt))
    tdt = getattr(torch, dtype)
    p, st, m = optim.adamw_update(params_from_reference(cfg, grads),
                                  opt_state_from_reference(cfg, opt), c, tdt)
    assert float(m["lr"]) == float(jm["lr"])
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    if clip < 1.0:
        assert float(jm["grad_norm"]) > clip           # the clip binds
    want = opt_state_from_reference(cfg, jax.tree.map(np.asarray, jst))
    assert int(st["step"]) == int(want["step"]) == 5
    assert st["step"].dtype == torch.int32
    for k in ("master", "m", "v"):
        for (n, a), (_, b) in zip(flatten_with_names(st[k]),
                                  flatten_with_names(want[k])):
            assert a.dtype == torch.float32
            if clip == 1.0:
                assert torch.equal(a, b), (k, n, _ulps(a, b))
            else:
                atol = (2e-3 * c.lr_peak if k == "master"
                        else 1e-6 * float(b.abs().max()))
                assert float((a - b).abs().max()) <= atol, (k, n)
    want_p = params_from_reference(cfg, jax.tree.map(np.asarray, jp))
    for (n, a), (_, b) in zip(flatten_with_names(p),
                              flatten_with_names(want_p)):
        assert a.dtype == tdt, n
        assert clip < 1.0 or torch.equal(a, b), n


def test_clipping_bounds_the_update_and_masters_stay_f32():
    """The reference's own checks (``tests/test_optim.py``): a huge
    gradient is clipped to norm 1 with its norm reported; a bf16 model
    trains on f32 masters and gets bf16 params back."""
    c = optim.AdamWConfig(lr_peak=1.0, warmup_steps=0, total_steps=10,
                          clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    _, st, m = optim.adamw_update({"w": torch.full((4,), 1e6)},
                                  optim.adamw_init(params), c, torch.float32)
    assert float(m["grad_norm"]) == pytest.approx(2e6, rel=1e-3)
    assert np.isfinite(float(m["lr"]))
    # the clipped gradient is 0.5 a component: m = (1 - b1) * 0.5
    assert torch.allclose(st["m"]["w"], torch.full((4,), 0.05))
    params = {"w": torch.zeros(3, dtype=torch.bfloat16)}
    opt = optim.adamw_init(params)
    assert opt["master"]["w"].dtype == torch.float32
    new_p, new_opt, _ = optim.adamw_update(
        {"w": torch.ones(3, dtype=torch.bfloat16)}, opt,
        optim.AdamWConfig(lr_peak=0.01, warmup_steps=0, total_steps=10),
        torch.bfloat16)
    assert new_p["w"].dtype == torch.bfloat16
    assert new_opt["master"]["w"].dtype == torch.float32
    assert float(optim.global_norm({"a": torch.tensor([3.0]),
                                    "b": [torch.tensor([4.0])]})) == 5.0


def test_adamw_converges_on_quadratic():
    c = optim.AdamWConfig(lr_peak=0.1, warmup_steps=5, total_steps=200,
                          weight_decay=0.0, clip_norm=100.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    opt = optim.adamw_init(params)
    for _ in range(200):
        g = {"w": 2 * (params["w"] - target)}
        params, opt, _ = optim.adamw_update(g, opt, c, torch.float32)
    torch.testing.assert_close(params["w"], target, atol=1e-2, rtol=0)
