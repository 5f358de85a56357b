"""Port parity: training (``repro_torch.models`` ``train_loss``,
``repro_torch.train``, ``repro_torch.launch.train``) against the
reference's (``repro``) on the CPU, and the gradient plumbing of the
kernels' autograd Functions.

Both sides get the reference's init, carried across by
``params_from_reference``, and the reference's ``host_batch``.  Configs
are ``smoke_reduce``d (f32; remat "nothing_saveable", their default).

Bands (PERF.md "Parity bands"):
  train_loss, every family          rtol 1e-5 (1.5e-7 seen); aux (MoE)
                                    rtol 1e-5; tokens exact
  gradients, every leaf             max |port - reference| <= 1e-5 x the
                                    leaf's max |g| (2.6e-6 seen); the
                                    SSD-scan families (mamba2, Jamba)
                                    3e-5 (1.1e-5, 1.5e-5 seen): the
                                    chunked scan's exp and cumsum
                                    differences grow through its
                                    backward
  flash branch (s = 2,048)          the same bands
  remat on / off                    torch.equal, every gradient leaf
  train step, 3 steps, microbatches losses rtol 1e-5; params atol
  1 and 2, vs the jitted reference  2 lr_peak (Adam's normalised step
                                    turns a gradient that differs in its
                                    last bits where it is near zero into
                                    a step of up to lr either way)
  crash + resume vs uninterrupted   losses exact (the reference's own
                                    test allows rtol 1e-5)
  KernelGrad: forward, backward     forward the kernel's output; backward
                                    torch.equal to the plain version's
  SSD scan gradient at chunk 256    the reference's where(exp) gives NaN
                                    for dA where the exponent overflows
                                    above the diagonal; the port's is
                                    finite; every other input's gradient
                                    within 1e-5 of the reference's max
                                    (4.8e-6 seen)
"""

import contextlib
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.data import host_batch as j_host_batch  # noqa: E402
from repro.kernels.ssd_scan.ref import _ssd_chunked_dA  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import (opt_state_from_reference,  # noqa: E402
                                 params_from_reference)
from repro_torch.kernels.autograd import KernelGrad  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_dA  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.train import (LoopConfig, make_eval_step,  # noqa: E402
                               make_train_step, run_training)
from repro_torch.train.step import value_and_grad  # noqa: E402
from repro_torch.utils.tree import flatten_with_names  # noqa: E402

SHAPE = ShapeConfig("t", seq_len=32, global_batch=2, kind="train")
SSD_FAMILIES = ("mamba2-780m", "jamba-v0.1-52b")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    jcfg = jconfigs.smoke_reduce(jconfigs.get_config(arch))
    cfg = configs.smoke_reduce(configs.get_config(arch))
    if kw:
        jcfg, cfg = jcfg.with_overrides(**kw), cfg.with_overrides(**kw)
    return jcfg, cfg


def _port_batch(hb):
    return {k: torch.from_numpy(np.array(v)) for k, v in hb.items()}


def _grads(api, params, batch, **kw):
    """(loss, metrics, {name: grad}) of the port's ``train_loss``."""
    loss, metrics, grads = value_and_grad(api, params, batch, **kw)
    return loss, metrics, dict(flatten_with_names(grads))


def _reference(jcfg, tree, hb):
    japi = j_build_model(jcfg)
    fn = jax.jit(jax.value_and_grad(japi.train_loss, has_aux=True))
    (loss, metrics), g = fn(jax.tree.map(jnp.asarray, tree),
                            {k: jnp.asarray(v) for k, v in hb.items()})
    return loss, metrics, jax.tree.map(np.asarray, g)


def _check_grads(cfg, mine, ref_tree, band):
    want = dict(flatten_with_names(params_from_reference(cfg, ref_tree)))
    assert sorted(mine) == sorted(want)
    for n, g in mine.items():
        scale = float(want[n].abs().max())
        diff = float((g - want[n]).abs().max())
        assert diff <= band * scale or diff == 0.0, (n, diff, scale)


@pytest.mark.parametrize("arch", list(configs.ARCH_IDS))
def test_train_loss_and_gradients_match_reference(arch):
    """``train_loss`` (its aux term for the MoE families, the VLM's prefix
    sliced off, Whisper's encoder) and the gradient of every leaf."""
    jcfg, cfg = _cfgs(arch)
    tree = jax.tree.map(np.asarray, j_build_model(jcfg).init_params(
        jax.random.key(0)))
    hb = j_host_batch(jcfg, SHAPE, 0)
    jloss, jm, jg = _reference(jcfg, tree, hb)
    api = build_model(cfg, device="cpu")
    loss, m, g = _grads(api, params_from_reference(cfg, tree),
                        _port_batch(hb))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5)
    assert float(m["tokens"]) == float(jm["tokens"])
    if cfg.moe.n_experts:
        assert float(m["aux"]) > 0
        np.testing.assert_allclose(
            float(loss), float(m["loss"]) + 0.01 * float(m["aux"]),
            rtol=1e-6)
    _check_grads(cfg, g, jg, 3e-5 if arch in SSD_FAMILIES else 1e-5)


def test_flash_branch_gradients_match_reference(monkeypatch):
    """One layer at 2,048 positions takes the flash branch
    (``use_flash="auto"``): the blocked plain version, whose gradient the
    kernel's autograd Function returns on the card."""
    jcfg, cfg = _cfgs("tinyllama-1.1b", n_layers=1, use_flash="auto")
    shape = ShapeConfig("t", seq_len=2048, global_batch=1, kind="train")
    tree = jax.tree.map(np.asarray, j_build_model(jcfg).init_params(
        jax.random.key(1)))
    hb = j_host_batch(jcfg, shape, 0)
    jloss, _, jg = _reference(jcfg, tree, hb)
    calls = []
    real = attn.ops.flash_attention
    monkeypatch.setattr(attn.ops, "flash_attention", lambda *a, **kw: (
        calls.append(a[0].shape), real(*a, **kw))[1])
    loss, _, g = _grads(build_model(cfg, device="cpu"),
                        params_from_reference(cfg, tree), _port_batch(hb))
    assert calls == [(1, 2048, 4, 32)] * 2          # forward and recompute
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _check_grads(cfg, g, jg, 1e-5)


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots"])
def test_remat_changes_no_gradient(policy):
    """Jamba's group (attention, Mamba-2, MLP and MoE layers): every
    gradient leaf under the checkpoint equals the run without it."""
    cfg = configs.smoke_reduce(configs.get_config("jamba-v0.1-52b"))
    api = build_model(cfg.with_overrides(remat_policy="none"), device="cpu")
    params = api.init_params(0)
    batch = _port_batch(j_host_batch(_cfgs("jamba-v0.1-52b")[0], SHAPE, 0))
    loss, _, g = _grads(api, params, batch)
    api_r = build_model(cfg.with_overrides(remat_policy=policy),
                        device="cpu")
    loss_r, _, g_r = _grads(api_r, params, batch)
    assert torch.equal(loss, loss_r)
    for n in g:
        assert torch.equal(g[n], g_r[n]), n


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jitted_reference(microbatches):
    """Three steps of ``make_train_step`` against the reference's jitted
    step from the same params, optimizer state and batches; the eval
    step's metrics are ``train_loss``'s."""
    jcfg, cfg = _cfgs("tinyllama-1.1b")
    shape = ShapeConfig("t", seq_len=32, global_batch=4, kind="train")
    jo = joptim.AdamWConfig(lr_peak=3e-4, warmup_steps=2, total_steps=12)
    o = optim.AdamWConfig(lr_peak=3e-4, warmup_steps=2, total_steps=12)
    japi = j_build_model(jcfg)
    tree = japi.init_params(jax.random.key(0))
    jopt = joptim.adamw_init(tree)
    jstep = jax.jit(j_make_train_step(japi, jo, microbatches))
    api = build_model(cfg, device="cpu")
    params = params_from_reference(cfg, jax.tree.map(np.asarray, tree))
    opt = opt_state_from_reference(cfg, jax.tree.map(np.asarray, jopt))
    step = make_train_step(api, o, microbatches)
    for i in range(3):
        hb = j_host_batch(jcfg, shape, i)
        tree, jopt, jm = jstep(tree, jopt,
                               {k: jnp.asarray(v) for k, v in hb.items()})
        params, opt, m = step(params, opt, _port_batch(hb))
        for k in ("loss", "aux", "lr", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-12, err_msg=k)
    want = params_from_reference(cfg, jax.tree.map(np.asarray, tree))
    for (n, a), (_, b) in zip(flatten_with_names(params),
                              flatten_with_names(want)):
        assert float((a - b).abs().max()) <= 2 * o.lr_peak, n
    assert int(opt["step"]) == 3
    ev = make_eval_step(api)(params, _port_batch(hb))
    loss, metrics = api.train_loss(params, _port_batch(hb))
    assert float(ev["loss"]) == float(metrics["loss"])


def test_crash_and_resume_equal_the_uninterrupted_run(tmp_path):
    """8 steps straight against 4 + a crash at step 6 + resume (the
    reference's ``tests/test_checkpoint.py`` case), port alone."""
    cfg = configs.smoke_reduce(configs.get_config("qwen2-1.5b"))
    api = build_model(cfg, device="cpu")
    o = optim.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=8)
    full = run_training(api, SHAPE, o, LoopConfig(
        steps=8, ckpt_dir=str(tmp_path / "a"), ckpt_every=4))
    lcfg = LoopConfig(steps=8, ckpt_dir=str(tmp_path / "b"), ckpt_every=4)
    with pytest.raises(RuntimeError, match="injected crash at step 6"):
        run_training(api, SHAPE, o, lcfg, crash_at_step=6)
    resumed = run_training(api, SHAPE, o, dataclasses.replace(
        lcfg, log_every=1), metrics_path=str(tmp_path / "m.jsonl"))
    assert resumed.resumed_from == 4 and resumed.final_step == 8
    assert full.losses[4:] == resumed.losses
    assert len(full.losses) == 8 and np.all(np.isfinite(full.losses))
    lines = [json.loads(x) for x in
             (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [4, 5, 6, 7]
    assert [x["loss"] for x in lines] == resumed.losses


def test_launch_train_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    res = train.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps",
                      "2", "--device", "cpu", "--ckpt-dir",
                      str(tmp_path)])
    out = capsys.readouterr().out
    assert "seq=64 batch=4 mb=1" in out and "done: steps=2" in out
    assert res.final_step == 2 and sorted(os.listdir(tmp_path)) == ["step_2"]


# --------------------------------------------- gradients through kernels

def test_f32_bmm_gradient_is_the_widened_products():
    """MoE's f32-result expert product: ``_F32Bmm``'s gradients (bf16 and
    f32 operands) equal autograd's through the widened operands."""
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        a = torch.randn(3, 8, 16, generator=gen).to(dtype).requires_grad_()
        w = torch.randn(3, 16, 5, generator=gen).to(dtype).requires_grad_()
        g = torch.randn(3, 8, 5, generator=gen)
        out = moe._f32_bmm(a, w)
        assert out.dtype == torch.float32 and out.grad_fn is not None
        ga, gw = torch.autograd.grad(out, (a, w), g)
        ra, rw = torch.autograd.grad(torch.bmm(a.float(), w.float()),
                                     (a, w), g)
        assert ga.dtype == dtype and torch.equal(ga, ra)
        assert gw.dtype == dtype and torch.equal(gw, rw)


@contextlib.contextmanager
def _stand_in(module, name, shift):
    """Replace the CUDA wrapper ``module.name`` by a CPU stand-in: the
    plain version plus ``shift`` (a forward that is visibly not the plain
    one), counting its calls."""
    real = getattr(module, name)
    plain = module._plain
    calls = []

    def kernel(*args, **kw):
        calls.append(args[0].shape)
        out = plain(*args, **{k: v for k, v in kw.items()
                              if k in ("chunk", "causal")},
                    **({"block_q": 128, "block_k": 128}
                       if name.startswith("flash") else {}))
        if isinstance(out, tuple):
            return tuple(o + shift for o in out)
        return out + shift
    setattr(module, name, kernel)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def test_flash_cuda_mode_under_autograd_returns_the_plain_gradient():
    """``flash_attention(force="cuda")`` while autograd records: the
    forward is the kernel's output, the backward the blocked plain
    version's gradient bit for bit; without autograd the kernel alone."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 256, 4, 32, generator=gen, requires_grad=True)
    k = torch.randn(1, 256, 2, 32, generator=gen, requires_grad=True)
    v = torch.randn(1, 256, 2, 32, generator=gen, requires_grad=True)
    g = torch.randn(1, 256, 4, 32, generator=gen)
    with _stand_in(flash_ops, "flash_attention_cuda", 1.0) as calls:
        out = flash_ops.flash_attention(q, k, v, force="cuda")
        assert calls == [q.shape] and out.grad_fn is not None
        got = torch.autograd.grad(out, (q, k, v), g)
        with torch.no_grad():
            served = flash_ops.flash_attention(q, k, v, force="cuda")
        assert len(calls) == 2 and served.grad_fn is None
    plain = flash_ops.flash_attention(q, k, v, force="torch")
    assert torch.equal(out, plain + 1.0) and torch.equal(served, out)
    want = torch.autograd.grad(plain, (q, k, v), g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_ssd_cuda_mode_under_autograd_returns_the_plain_gradient():
    """``ssd_scan(force="cuda")`` while autograd records, model layout:
    the gradients for x, dt, dA, B and C through y and the final state
    are the plain version's bit for bit, and a gradient that reaches only
    y works too (the state's is None)."""
    gen = torch.Generator().manual_seed(1)
    b, l, h, p, g_, n = 1, 64, 4, 8, 1, 16
    x = torch.randn(b, l, h, p, generator=gen, requires_grad=True)
    dt = (torch.rand(b, l, h, generator=gen) * 0.5).requires_grad_()
    dA = (-torch.rand(b, l, h, generator=gen) * 0.5).requires_grad_()
    B = torch.randn(b, l, g_, n, generator=gen, requires_grad=True)
    C = torch.randn(b, l, g_, n, generator=gen, requires_grad=True)
    gy = torch.randn(b, l, h, p, generator=gen)
    gs = torch.randn(b, h, p, n, generator=gen)
    ins = (x, dt, dA, B, C)
    with _stand_in(ssd_ops, "ssd_scan_cuda", 0.5) as calls:
        y, s = ssd_ops.ssd_scan(*ins, chunk=16, force="cuda")
        got = torch.autograd.grad((y, s), ins, (gy, gs))
        y2, _ = ssd_ops.ssd_scan(*ins, chunk=16, force="cuda")
        got_y = torch.autograd.grad(y2, ins, gy)
        assert len(calls) == 2
    py, ps = ssd_ops.ssd_scan(*ins, chunk=16, force="torch")
    assert torch.equal(y, py + 0.5) and torch.equal(s, ps + 0.5)
    want = torch.autograd.grad((py, ps), ins, (gy, gs))
    want_y = torch.autograd.grad(
        ssd_ops.ssd_scan(*ins, chunk=16, force="torch")[0], ins, gy)
    for a, b_, c, d in zip(got, want, got_y, want_y):
        assert torch.equal(a, b_) and torch.equal(c, d)


def test_kernel_grad_skips_inputs_that_need_none():
    x = torch.randn(5, requires_grad=True)
    y = torch.randn(5)
    out = KernelGrad.apply(lambda a, b: a * b + 3, lambda a, b: a * b, x, y)
    gx, = torch.autograd.grad(out.sum(), (x,))
    assert torch.equal(gx, y)


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    """mamba2-780m's chunk of 256 at its initial dt * A (dt ~ 0.7, A = -1):
    cum falls by ~180 within a chunk, so exp(cum_i - cum_j) above the
    diagonal overflows.  The reference's gradient for dA is NaN there
    (0 * inf through its where); the port masks the exponent first.  Its
    forward is unchanged, and every gradient the reference gets finite is
    the port's within 1e-5 of its max."""
    rng = np.random.default_rng(0)
    b, l, h, p, g, n = 1, 512, 2, 8, 1, 8
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (0.6 + 0.2 * rng.random((b, l, h))).astype(np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    ins = (x, dt, -dt, B, C)

    def jloss(*a):
        y, s = _ssd_chunked_dA(*a, 256)
        return y.sum() + s.sum()
    jg = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, ins))
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, s = ssd_chunked_dA(*ts, 256)
    got = torch.autograd.grad(y.sum() + s.sum(), ts)
    jy, _ = _ssd_chunked_dA(*map(jnp.asarray, ins), 256)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=0, atol=2e-4)   # the reference's own
    assert not np.isfinite(np.asarray(jg[2])).any()     # the reference: NaN
    for a, t in zip(jg, got):
        assert bool(torch.isfinite(t).all())
        a = np.asarray(a)
        fin = np.isfinite(a)
        if fin.any():
            assert np.abs(a[fin] - t.numpy()[fin]).max() <= 1e-5 * np.abs(
                a[fin]).max()
