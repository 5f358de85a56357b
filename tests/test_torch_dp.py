"""Port parity: the hierarchical data-parallel trainer
(``repro_torch.train.dp``) against the reference's ``make_dp_train_step``
on a ``('pod', 'data')`` host-device mesh, on the CPU.

The reference needs an 8-device host platform, so it runs once in a
subprocess (``REFERENCE``) that writes an npz: per step the loss, the
params and every device's ``err_state`` shard; the port runs the same
steps on a CPU ``Mesh`` in this process.  Cases:

  toy      the least-squares loss of ``tests/test_dp_compressed.py`` on
           the (2, 4) mesh, f32, 3 steps, compressed and not
  llama    smoke tinyllama-1.1b in f32 (as ``tests/test_elastic.py``
           overrides it) on a (2, 2) mesh of the first four devices, 2
           compressed steps, free-running; and its step 2 again from the
           reference's step-1 state (``convert.err_state_from_reference``
           carries its per-pod residuals across)
  pmean    the reference's ``shard_map`` ``pmean`` over 'data' of seeded
           [8, 4096] inputs on the (2, 4) mesh, f32 and bf16

Bands (PERF.md "Parity bands"): losses rtol 1e-6 (toy) / 1e-5 (llama,
the training band of ``tests/test_torch_train.py``), gradient norms
rtol 1e-5.  Each pod's residual against the reference's shard on that
pod's devices, element by element, in units of that pod's int8 step of
the tensor (its max |target| / 127): within ``RESID_TOL`` of it, or a
tie that the two round the other way (a flip: exactly one step apart,
within ``RESID_TOL``), at most ``MAX_FLIPS`` flips a case; an element
that flipped at an earlier step of a free-running case is exempt (its
target then differs by a step).  Params against the reference's within
``PARAM_TOL`` of that step's learning rate, and within one learning rate
where a pod flipped.  ``pmean`` exact.  The port quantizes the per-layer
slices of a stacked reference leaf with one scale
(``stacked=api.stacked_name``), as the reference quantizes the stacked
tensor.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import (err_state_from_reference,  # noqa: E402
                                 opt_state_from_reference,
                                 params_from_reference)
from repro_torch.data import (SyntheticStream, device_batch,  # noqa: E402
                              host_batch)
from repro_torch.launch.mesh import _make_mesh  # noqa: E402
from repro_torch.launch.specs import batch_partition_specs, named  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, lr_schedule  # noqa: E402
from repro_torch.sharding import PartitionSpec as P  # noqa: E402
from repro_torch.sharding import lm_rules  # noqa: E402
from repro_torch.train import dp, init_dp_state, make_dp_train_step  # noqa: E402
from repro_torch.train.dp import pmean  # noqa: E402
from repro_torch.utils.tree import flatten_with_names  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _threads():
    """Two intra-op threads: the tier-1 run uses six workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOY_STEPS, LLAMA_STEPS = 3, 2
TOY_OCFG = dict(lr_peak=3e-2, warmup_steps=5, total_steps=150,
                weight_decay=0.0)
LLAMA_OCFG = dict(lr_peak=3e-4, warmup_steps=2, total_steps=12)
LLAMA_SHAPE = dict(seq_len=32, global_batch=4)
# the f32 noise of the two gradients, in int8 steps (measured at most
# 2.3e-4) and in learning rates (at most 1e-4); a wrong residual is off
# by up to half a step
RESID_TOL, PARAM_TOL = 1e-3, 1e-3
MAX_FLIPS = 16      # measured 0 (toy) and 4-8 (llama) a case

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from functools import partial
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import get_config, smoke_reduce
from repro.configs.base import ShapeConfig
from repro.data import host_batch
from repro.launch.mesh import _make_mesh
from repro.models import build_model
from repro.optim import AdamWConfig
from repro.train.dp import init_dp_state, make_dp_train_step
from repro.utils.tree import flatten_with_names

TOY_STEPS, LLAMA_STEPS = %(steps)s
out = {}

def put(prefix, tree):
    for n, x in flatten_with_names(tree):
        out[f"{prefix}/{n}"] = np.asarray(x)

def put_err(prefix, err, mesh):
    # every device's shard; pod p's devices are mesh.devices[p]
    pos = {d: i for i, d in enumerate(mesh.devices.flat)}
    for n, x in flatten_with_names(err):
        for s in x.addressable_shards:
            out[f"{prefix}/{pos[s.device]}/{n}"] = np.asarray(s.data)

mesh = _make_mesh((2, 4), ("pod", "data"))
key = jax.random.key(0)
w_true = jax.random.normal(key, (16, 32)) * 0.5

def toy_loss(params, batch):
    pred = batch["x"] @ params["w"]
    return jnp.mean((pred - batch["y"]) ** 2)

ocfg = AdamWConfig(**%(toy_ocfg)s)
for compress in (False, True):
    p = {"w": jnp.zeros((16, 32))}
    opt, err = init_dp_state(p)
    step = make_dp_train_step(toy_loss, mesh, ocfg, compress_cross_pod=compress)
    for i in range(TOY_STEPS):
        k = jax.random.fold_in(key, i)
        x = jax.random.normal(k, (64, 16))
        y = x @ w_true + 0.01 * jax.random.normal(k, (64, 32))
        out[f"toy/x/{i}"], out[f"toy/y/{i}"] = np.asarray(x), np.asarray(y)
        p, opt, err, loss, gn = step(p, opt, err, {"x": x, "y": y})
        tag = f"toy{int(compress)}/{i}"
        out[f"{tag}/loss"], out[f"{tag}/gn"] = np.asarray(loss), np.asarray(gn)
        put(f"{tag}/params", p)
        put_err(f"{tag}/err", err, mesh)

cfg = smoke_reduce(get_config("tinyllama-1.1b")).with_overrides(dtype="float32")
api = build_model(cfg)
shape = ShapeConfig("t", kind="train", **%(shape)s)
mesh4 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("pod", "data"))
params = jax.jit(api.init_params)(jax.random.key(0))
put("llama/init", params)
opt, err = init_dp_state(params)
step = make_dp_train_step(lambda p, b: api.train_loss(p, b)[0], mesh4,
                          AdamWConfig(**%(llama_ocfg)s))
for i in range(LLAMA_STEPS):
    hb = host_batch(cfg, shape, i)
    params, opt, err, loss, gn = step(params, opt, err,
                                      {k: jnp.asarray(v) for k, v in hb.items()})
    tag = f"llama/{i}"
    out[f"{tag}/loss"], out[f"{tag}/gn"] = np.asarray(loss), np.asarray(gn)
    put(f"{tag}/params", params)
    put(f"{tag}/opt", opt)
    put_err(f"{tag}/err", err, mesh4)

rng = np.random.default_rng(0)
x = (rng.standard_normal((8, 4096))
     * rng.uniform(0.1, 10, (8, 1))).astype(np.float32)
sm = partial(jax.shard_map, check_vma=False)
f = jax.jit(sm(lambda a: jax.lax.pmean(a, "data"), mesh=mesh,
               in_specs=P(("pod", "data")), out_specs=P(("pod", "data"))))
out["pmean/x"] = x
for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
    out[f"pmean/{name}"] = np.asarray(f(jnp.asarray(x).astype(dt))
                                      .astype(jnp.float32))
np.savez(sys.argv[1], **out)
print("REFERENCE DP OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dp") / "ref.npz")
    script = REFERENCE % dict(steps=(TOY_STEPS, LLAMA_STEPS),
                              toy_ocfg=TOY_OCFG, shape=LLAMA_SHAPE,
                              llama_ocfg=LLAMA_OCFG)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", script, path], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    with np.load(path) as z:
        return dict(z)


def _tree(ref, prefix):
    """The nested dict of the flat ``prefix/...`` entries of ``ref``."""
    root = {}
    for key, v in ref.items():
        if not key.startswith(prefix + "/"):
            continue
        node, *path = key[len(prefix) + 1:].split("/")
        parts = [node, *path]
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _pods(ref, prefix, n_pod, n_data):
    """The reference's per-pod residual trees (device p * n_data's
    shard), after checking that the devices of each pod agree."""
    tree = _tree(ref, prefix)
    for p in range(n_pod):
        for d in range(1, n_data):
            a = dict(flatten_with_names(tree[str(p * n_data)]))
            b = dict(flatten_with_names(tree[str(p * n_data + d)]))
            assert all(np.array_equal(a[n], b[n]) for n in a)
    return [tree[str(p * n_data)] for p in range(n_pod)]


def _int8_steps(grads, errs, tensor_of):
    """Each leaf's int8 step, max |grad + residual| / 127 over the tensor
    it is a slice of, for each pod (``compressed_psum``'s inputs)."""
    tensor_of = tensor_of or (lambda name: name)
    out = []
    for g_tree, e_tree in zip(grads, errs):
        e, amax = dict(flatten_with_names(e_tree)), {}
        for n, g in flatten_with_names(g_tree):
            a, t = float((g.float() + e[n]).abs().max()), tensor_of(n)
            amax[t] = max(amax.get(t, 0.0), a)
        out.append({n: max(amax[tensor_of(n)], 1e-12) / 127.0
                    for n, _ in flatten_with_names(g_tree)})
    return out


@pytest.fixture
def int8_steps(monkeypatch):
    """The last step's ``_int8_steps``, recorded from the inputs of the
    trainer's ``compressed_psum``."""
    rec, real = [], dp.compressed_psum

    def spy(grads, errs, tensor_of=None):
        rec[:] = _int8_steps(grads, errs, tensor_of)
        return real(grads, errs, tensor_of)
    monkeypatch.setattr(dp, "compressed_psum", spy)
    return rec


def _check_err(mine, want_trees, steps, carried, cfg=None):
    """Each pod's residual against the reference's, element by element
    (module docstring); ``carried[p][name]``: pod p's earlier flips,
    exempt.  Adds this step's flips to ``carried`` and returns (elements
    that differ at all, flips)."""
    if cfg is not None:
        want = err_state_from_reference(cfg, want_trees)
    else:
        want = [{k: torch.from_numpy(v) for k, v in t.items()}
                for t in want_trees]
    assert len(mine) == len(want)
    differ = flips = 0
    for p, (a_tree, b_tree) in enumerate(zip(mine, want)):
        b = dict(flatten_with_names(b_tree))
        for n, a in flatten_with_names(a_tree):
            d = (a - b[n]).abs() / steps[p][n]
            flip = (d - 1).abs() <= RESID_TOL
            old = carried[p].get(n, torch.zeros_like(flip))
            bad = ~(flip | old | (d <= RESID_TOL))
            assert not bad.any(), (p, n, float(d[bad].max()))
            carried[p][n] = old | flip
            differ += int((d > 0).sum())
            flips += int(flip.sum())
    assert flips <= MAX_FLIPS, flips
    return differ, flips


def _check_params(mine, want, lr, carried):
    """Params within ``PARAM_TOL`` learning rates of the reference's, and
    within one where a pod's residual flipped (``carried``)."""
    want = dict(flatten_with_names(want))
    for n, a in flatten_with_names(mine):
        d = (a - want[n]).abs() / lr
        flipped = torch.zeros_like(d, dtype=torch.bool)
        for pod in carried:
            flipped |= pod.get(n, flipped)
        bad = ~((d <= PARAM_TOL) | (flipped & (d <= 1)))
        assert not bad.any(), (n, float(d[bad].max()))


def _mesh(shape):
    return _make_mesh(shape, ("pod", "data"), device="cpu")


def _toy_loss(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


@pytest.mark.slow
def test_dp_steps_match_the_reference(ref, int8_steps, capsys):
    mesh = _mesh((2, 4))
    report = {}
    for compress in (False, True):
        p = {"w": torch.zeros((16, 32))}
        opt, err = init_dp_state(p)
        ocfg = AdamWConfig(**TOY_OCFG)
        step = make_dp_train_step(_toy_loss, mesh, ocfg,
                                  compress_cross_pod=compress)
        carried = [{}, {}]
        for i in range(TOY_STEPS):
            batch = {k: torch.from_numpy(ref[f"toy/{k}/{i}"])
                     for k in ("x", "y")}
            p, opt, err, loss, gn = step(p, opt, err, batch)
            tag = f"toy{int(compress)}/{i}"
            np.testing.assert_allclose(float(loss), ref[f"{tag}/loss"],
                                       rtol=1e-6)
            np.testing.assert_allclose(float(gn), ref[f"{tag}/gn"],
                                       rtol=1e-5)
            if compress:
                report[tag] = _check_err(err, _pods(ref, f"{tag}/err", 2, 4),
                                         int8_steps, carried)
            else:
                assert err["w"].dtype == torch.float32 and not err["w"].any()
            _check_params(p, {"w": torch.from_numpy(ref[f"{tag}/params/w"])},
                          float(lr_schedule(ocfg, i + 1)), carried)

    # smoke tinyllama in f32 on (2, 2): free-running, then step 2 again
    # from the reference's step-1 state
    cfg = configs.smoke_reduce(configs.get_config(
        "tinyllama-1.1b")).with_overrides(dtype="float32")
    api = build_model(cfg, device="cpu")
    ocfg = AdamWConfig(**LLAMA_OCFG)
    shape = ShapeConfig("t", kind="train", **LLAMA_SHAPE)
    mesh = _mesh((2, 2))
    step = make_dp_train_step(lambda p_, b: api.train_loss(p_, b)[0], mesh,
                              ocfg, stacked=api.stacked_name)
    params = params_from_reference(cfg, _tree(ref, "llama/init"))
    opt, err = init_dp_state(params)
    carried = [{}, {}]
    for i in range(LLAMA_STEPS):
        params, opt, err, loss, gn = step(params, opt, err,
                                          device_batch(cfg, shape, i, "cpu"))
        tag = f"llama/{i}"
        np.testing.assert_allclose(float(loss), ref[f"{tag}/loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(gn), ref[f"{tag}/gn"], rtol=1e-5)
        report[tag] = _check_err(err, _pods(ref, f"{tag}/err", 2, 2),
                                 int8_steps, carried, cfg)
        _check_params(params, params_from_reference(
            cfg, _tree(ref, f"{tag}/params")),
            float(lr_schedule(ocfg, i + 1)), carried)
        assert any(float((a - b).abs().max()) > 0 for (_, a), (_, b) in zip(
            flatten_with_names(err[0]), flatten_with_names(err[1])))
    # step 2 from the reference's step-1 state, the batch laid out on the
    # mesh by the launcher's batch specs: the gradient norm, the params
    # and the residuals read the incoming residuals
    shardings = named(mesh, batch_partition_specs(
        cfg, shape, mesh, lm_rules(multi_pod=True)))
    params = params_from_reference(cfg, _tree(ref, "llama/0/params"))
    opt = opt_state_from_reference(cfg, _tree(ref, "llama/0/opt"))
    err = err_state_from_reference(cfg, _pods(ref, "llama/0/err", 2, 2))
    params, _, err, loss, gn = step(params, opt, err, device_batch(
        cfg, shape, 1, shardings=shardings))
    np.testing.assert_allclose(float(loss), ref["llama/1/loss"], rtol=1e-5)
    np.testing.assert_allclose(float(gn), ref["llama/1/gn"], rtol=1e-5)
    carried = [{}, {}]
    report["llama/1 forced"] = _check_err(
        err, _pods(ref, "llama/1/err", 2, 2), int8_steps, carried, cfg)
    _check_params(params, params_from_reference(
        cfg, _tree(ref, "llama/1/params")), float(lr_schedule(ocfg, 2)),
        carried)
    with capsys.disabled():
        print(f"\nresidual elements (differing, flips) against the "
              f"reference: {report}")

    # pmean over 'data', exactly (f32: added in shard order; bf16: added
    # in f32, rounded once), and the two sums it is not
    x = torch.from_numpy(ref["pmean/x"])
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        want = torch.from_numpy(ref[f"pmean/{name}"])
        xs = x.to(dt)
        for pod in range(2):
            rows = list(xs[pod * 4:(pod + 1) * 4])
            got = pmean(rows)
            assert got.dtype == dt
            for d in range(4):
                assert torch.equal(got.float(), want[pod * 4 + d])
            seq = ((rows[0] + rows[1]) + rows[2]) + rows[3]
            pair = (rows[0] + rows[1]) + (rows[2] + rows[3])
            if dt == torch.float32:
                assert not torch.equal((pair / 4).float(), want[pod * 4])
            else:
                for other in (seq, pair):
                    assert not torch.equal((other / 4).float(),
                                           want[pod * 4])


def test_dp_step_on_sharded_and_plain_batches_agree():
    """A batch of tensors and the same batch laid out on the mesh by
    ``P(("pod", "data"))`` give the same step; a replicated residual tree
    and its per-pod list likewise.  Refused: a batch laid out on another
    mesh or by another spec, a model's params without ``stacked``, and a
    mesh other than ('pod', 'data')."""
    cfg = configs.smoke_reduce(configs.get_config(
        "qwen2-1.5b")).with_overrides(n_layers=1)
    api = build_model(cfg, device="cpu")
    shape = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
    mesh = _mesh((2, 2))
    step = make_dp_train_step(lambda p_, b: api.train_loss(p_, b)[0], mesh,
                              AdamWConfig(lr_peak=1e-3, warmup_steps=1),
                              stacked=api.stacked_name)
    params = api.init_params(0)
    opt, err = init_dp_state(params)
    plain = step(params, opt, err, device_batch(cfg, shape, 0, "cpu"))
    shardings = named(mesh, batch_partition_specs(
        cfg, shape, mesh, lm_rules(multi_pod=True)))
    laid = device_batch(cfg, shape, 0, shardings=shardings)
    streamed = next(SyntheticStream(cfg, shape, shardings=shardings))
    hb = host_batch(cfg, shape, 0)
    for k, x in laid.items():
        assert x.shards.shape == (2, 2)
        for i, pos in enumerate(np.ndindex(2, 2)):
            want = torch.from_numpy(hb[k][i:i + 1])
            assert torch.equal(x.shards[pos], want)
            assert torch.equal(streamed[k].shards[pos], want)
    sharded = step(params, opt, [err, err], laid)
    for a, b in ((plain[0], sharded[0]), (plain[2], sharded[2])):
        for (_, x), (_, y) in zip(flatten_with_names(a),
                                  flatten_with_names(b)):
            assert torch.equal(x, y)
    assert torch.equal(plain[3], sharded[3])
    assert len(plain[2]) == 2
    with pytest.raises(ValueError, match="residual trees"):
        step(params, opt, [err] * 3, laid)
    with pytest.raises(ValueError, match="does not split"):
        step(params, opt, err, device_batch(
            cfg, ShapeConfig("t", seq_len=16, global_batch=6, kind="train"),
            0, "cpu"))
    with pytest.raises(ValueError, match="laid-out batch leaf"):
        step(params, opt, err, device_batch(cfg, shape, 0, shardings=named(
            _mesh((2, 2)), batch_partition_specs(
                cfg, shape, mesh, lm_rules(multi_pod=True)))))
    with pytest.raises(ValueError, match="laid-out batch leaf"):
        step(params, opt, err, device_batch(cfg, shape, 0, shardings=named(
            mesh, {k: P(None, ("pod", "data")) for k in laid})))
    with pytest.raises(ValueError, match="stacked_name"):
        make_dp_train_step(lambda p_, b: api.train_loss(p_, b)[0], mesh,
                           AdamWConfig())(params, opt, err, laid)
    with pytest.raises(ValueError, match="'pod', 'data'"):
        make_dp_train_step(None, _make_mesh((2, 2), ("data", "model"),
                                            device="cpu"), AdamWConfig())


def test_model_dtype_is_the_first_sorted_leaf():
    """A bf16 model's reduced gradients go through the optimizer in f32
    and its new params come back in bf16, its first leaf's dtype."""
    mesh = _mesh((1, 2))
    params = {"w": torch.ones((4, 2), dtype=torch.bfloat16),
              "z": torch.ones((2,), dtype=torch.float32)}

    def loss_fn(p, b):
        return ((b["x"] @ p["w"].float()).sum(-1) * p["z"].sum()).mean()
    step = make_dp_train_step(loss_fn, mesh, AdamWConfig(warmup_steps=1))
    opt = adamw_init(params)
    x = torch.arange(8.0).reshape(2, 4)
    new, _, err, loss, gn = step(params, opt, [{"w": torch.zeros(4, 2),
                                                "z": torch.zeros(2)}], {"x": x})
    assert new["w"].dtype == new["z"].dtype == torch.bfloat16
    assert err[0]["w"].dtype == torch.float32 and torch.isfinite(gn)
