"""Port parity: the sharding rules (``repro_torch.sharding``), the meshes
and ``launch/specs.py`` against the reference's (``repro.sharding``,
``repro.launch.specs``), specs only (no device state), and the elastic
restart on a CPU mesh.

The port's parameter tree is per layer (``layers/<i>/...``,
``enc_layers/<i>/...``), the reference's stacked (``groups/pos<j>/...``,
``enc_layers/...`` with a leading layer dim): a port leaf's spec must
equal its counterpart's without the stacked leading None.  Specs are
compared as tuples (the port's ``PartitionSpec`` is a tuple subclass
kept in the reference's canonical form).  Every comparison is exact.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.sharding import ctx as jctx  # noqa: E402
from repro.sharding import params as jparams  # noqa: E402
from repro.utils.tree import flatten_with_names as j_flatten  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import group_size  # noqa: E402
from repro_torch.optim import adamw_init, adamw_init_specs  # noqa: E402
from repro_torch.sharding import (NamedSharding, PartitionSpec,  # noqa: E402
                                  lm_rules, use_rules)
from repro_torch.sharding import grid  # noqa: E402
from repro_torch.sharding.ctx import current_rules, dispatch_shards  # noqa: E402
from repro_torch.sharding.params import (param_partition_spec,  # noqa: E402
                                         tree_partition_specs)
from repro_torch.utils.tree import flatten_with_names  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _threads():
    """Two intra-op threads: the tier-1 run uses six workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


ARCHS = list(configs.ARCH_IDS)
SIZES = {"1pod": {"data": 16, "model": 16},
         "2pod": {"pod": 2, "data": 16, "model": 16}}
DECODE = [n for n, s in configs.SHAPES.items() if s.kind == "decode"]
INPUT = [n for n, s in configs.SHAPES.items() if s.kind != "decode"]


def _fake_mesh(sizes):
    class _Mesh:
        axis_names = tuple(sizes)

        class devices:
            shape = tuple(sizes.values())
    return _Mesh


@functools.lru_cache(maxsize=None)
def _ref_param_tree(arch):
    return j_build_model(jconfigs.get_config(arch)).param_specs()


@functools.lru_cache(maxsize=None)
def _ref_param_specs(arch):
    return dict(j_flatten(_ref_param_tree(arch)))


@functools.lru_cache(maxsize=None)
def _port_param_specs(arch):
    cfg = configs.get_config(arch)
    return dict(flatten_with_names(build_model(cfg, device="cpu")
                                   .param_specs()))


def _ref_name(cfg, name):
    """(the reference's path of the port's leaf ``name``, stacked?)."""
    parts = name.split("/")
    if parts[0] == "layers":
        j = int(parts[1]) % group_size(cfg)
        return "/".join(["groups", f"pos{j}", *parts[2:]]), True
    if parts[0] in ("enc_layers", "dec_layers"):
        return "/".join([parts[0], *parts[2:]]), True
    return name, False


def _check_against_reference(cfg, port_leaves, ref_leaves, port_spec,
                             ref_spec):
    """Every port leaf's spec is its counterpart's (modulo the stacked
    None); every reference leaf has a counterpart."""
    hit = set()
    for name, x in port_leaves.items():
        rname, stacked = _ref_name(cfg, name)
        ref = ref_leaves[rname]
        assert tuple(ref.shape[int(stacked):]) == tuple(x.shape), name
        want = tuple(ref_spec(rname, ref))
        if stacked:
            assert want[0] is None, (rname, want)
            want = want[1:]
        got = port_spec(name, x)
        assert isinstance(got, PartitionSpec)
        assert tuple(got) == want, (cfg.name, name, got, want)
        hit.add(rname)
    assert hit == set(ref_leaves)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
def test_lm_rules_equal_the_reference(multi_pod, fsdp):
    assert lm_rules(multi_pod, fsdp) == jctx.lm_rules(multi_pod, fsdp)


@pytest.mark.parametrize("parts", [("data", None), (("data",), None),
                                   (("pod", "data"),), (), ((), "model"),
                                   (["data", "model"], None, None)])
def test_partition_spec_is_the_references_tuple(parts):
    from jax.sharding import PartitionSpec as JP
    spec = PartitionSpec(*parts)
    assert tuple(spec) == tuple(JP(*parts))
    assert spec == JP(*parts) and spec == tuple(JP(*parts))
    assert len(flatten_with_names({"s": spec})) == 1      # a tree leaf


@pytest.mark.parametrize("mesh", list(SIZES))
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, fsdp, mesh):
    cfg = configs.get_config(arch)
    sizes = SIZES[mesh]
    rules = lm_rules(mesh == "2pod", fsdp)
    jrules = jctx.lm_rules(mesh == "2pod", fsdp)
    _check_against_reference(
        cfg, _port_param_specs(arch), _ref_param_specs(arch),
        lambda n, x: param_partition_spec(n, tuple(x.shape), rules, sizes),
        lambda n, x: jparams.param_partition_spec(n, tuple(x.shape), jrules,
                                                  sizes))


@pytest.mark.parametrize("path, shape, fsdp, want", [
    # llama4: 40 q-heads do not divide model=16 -> heads unsharded, FSDP
    ("layers/0/attn/wq", (5120, 40, 128), True, (("data"), None, None)),
    # qwen2: 2 kv heads
    ("layers/0/attn/wk", (1536, 2, 128), False, (None, None, None)),
    ("layers/0/attn/wq", (6144, 48, 128), False, (None, "model", None)),
    ("embed/table", (202048, 5120), False, ("model", None)),
    ("embed/table", (50280, 1536), False, (None, None)),   # mamba2 vocab
    ("layers/0/moe/wi", (64, 2048, 1408), True, ("model", "data", None)),
])
def test_named_cases_of_the_reference(path, shape, fsdp, want):
    """``tests/test_sharding.py``'s cases on the port's per-layer paths."""
    got = param_partition_spec(path, shape, lm_rules(False, fsdp),
                               SIZES["1pod"])
    assert tuple(got) == want
    rpath = path.replace("layers/0", "groups/pos0")
    ref = jparams.param_partition_spec(
        rpath, (7, *shape) if rpath != path else shape,
        jctx.lm_rules(False, fsdp), SIZES["1pod"])
    assert tuple(ref)[int(rpath != path):] == want


def _jflat(spec_tree):
    """A reference spec tree as {path: spec} (its specs as leaves)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): v for path, v in leaves}


def _same_by_name(got: dict, want: dict):
    """Every port spec equals every reference spec of its leaf name."""
    assert ({n.split("/")[-1] for n in got}
            == {n.split("/")[-1] for n in want})
    for n, spec in got.items():
        name = n.split("/")[-1]
        others = {tuple(v) for k, v in want.items()
                  if k.split("/")[-1] == name}
        assert others == {tuple(spec)}, (n, spec, others)


@pytest.mark.parametrize("mesh", list(SIZES))
@pytest.mark.parametrize("shape_name", DECODE)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, shape_name, mesh):
    """Each port cache leaf (``k``/``v`` [La, ...], ``conv``/``state``
    [Lm, ...], Whisper's ``self_*``/``mem_*``) has the spec of every
    reference leaf of its name (``pos<j>/k`` [G, ...])."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    shape = configs.SHAPES[shape_name]
    fake = _fake_mesh(SIZES[mesh])
    b, s = shape.global_batch, shape.seq_len
    got = dict(flatten_with_names(specs.cache_partition_specs(
        cfg, shape, fake, lm_rules(mesh == "2pod", cfg.fsdp),
        build_model(cfg, device="cpu").decode_cache_specs(b, s))))
    want = _jflat(jspecs.cache_partition_specs(
        jcfg, shape, fake, jctx.lm_rules(mesh == "2pod", jcfg.fsdp),
        j_build_model(jcfg).decode_cache_specs(b, s)))
    _same_by_name(got, want)


def test_cache_specs_of_the_references_named_cases():
    """``tests/test_launch_specs.py``'s cases on the port's cache."""
    def spec(arch, shape_name, leaf):
        cfg = configs.get_config(arch)
        shape = configs.SHAPES[shape_name]
        tree = specs.cache_partition_specs(
            cfg, shape, _fake_mesh(SIZES["1pod"]), lm_rules(False, cfg.fsdp),
            build_model(cfg, device="cpu").decode_cache_specs(
                shape.global_batch, shape.seq_len))
        return tree[leaf]
    k = spec("phi-3-vision-4.2b", "decode_32k", "k")     # kv 32 divides 16
    assert k[3] == "model" and k[2] is None
    k = spec("internlm2-20b", "decode_32k", "k")         # seq fallback
    assert k[3] is None and k[2] == "model"
    k = spec("jamba-v0.1-52b", "long_500k", "k")         # batch 1
    assert k[1] is None and k[2] == ("data", "model")
    assert spec("mamba2-780m", "decode_32k", "state")[2] == "model"
    mem = spec("whisper-medium", "decode_32k", "mem_k")
    assert len(mem) == 5 and mem[3] == "model"


@pytest.mark.parametrize("mesh", list(SIZES))
@pytest.mark.parametrize("shape_name", INPUT)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_the_reference(arch, shape_name, mesh):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    shape = configs.SHAPES[shape_name]
    fake = _fake_mesh(SIZES[mesh])
    got = specs.batch_partition_specs(cfg, shape, fake,
                                      lm_rules(mesh == "2pod", cfg.fsdp))
    want = jspecs.batch_partition_specs(
        jcfg, shape, fake, jctx.lm_rules(mesh == "2pod", jcfg.fsdp))
    assert {k: tuple(v) for k, v in got.items()} == {
        k: tuple(v) for k, v in want.items()}
    if arch == "tinyllama-1.1b" and shape_name == "train_4k":
        assert got["tokens"] == (("pod", "data") if mesh == "2pod"
                                 else "data", None)


def _meta_equal(a, b):
    fa, fb = flatten_with_names(a), flatten_with_names(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (n, x), (_, y) in zip(fa, fb):
        assert tuple(x.shape) == tuple(y.shape) and x.dtype == y.dtype, n


def _jdtype(dt):
    return getattr(torch, jnp.dtype(dt).name)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_optimizer_specs_equal_init(arch):
    """``param_specs`` / ``adamw_init_specs``: meta tensors with
    ``init_params`` / ``adamw_init``'s shapes and dtypes (smoke size) and
    the reference's ``param_specs`` / ``adamw_init_specs`` (full size,
    modulo the stacked dim)."""
    cfg = configs.smoke_reduce(configs.get_config(arch))
    api = build_model(cfg, device="cpu")
    pspecs = api.param_specs()
    assert all(x.device.type == "meta" for _, x in flatten_with_names(pspecs))
    params = api.init_params(0)
    _meta_equal(pspecs, params)
    _meta_equal(adamw_init_specs(pspecs), adamw_init(params))
    full = configs.get_config(arch)
    port = dict(flatten_with_names(adamw_init_specs(
        build_model(full, device="cpu").param_specs())["master"]))
    ref_opt = joptim.adamw_init_specs(_ref_param_tree(arch))
    ref = dict(j_flatten(ref_opt["master"]))
    for name, x in port.items():
        rname, stacked = _ref_name(full, name)
        assert tuple(ref[rname].shape[int(stacked):]) == tuple(x.shape)
        assert _jdtype(ref[rname].dtype) == x.dtype == torch.float32
    for name, x in _port_param_specs(arch).items():
        rname, stacked = _ref_name(full, name)
        assert _jdtype(_ref_param_specs(arch)[rname].dtype) == x.dtype, name
    assert ref_opt["step"].dtype == jnp.int32


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "moonshot-v1-16b-a3b",
                                  "whisper-medium"])
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_build_all_specs(arch, shape_name):
    """``build_all_specs`` on the multi-pod fake mesh: every tree the
    reference's builds, with its specs."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    shape = configs.SHAPES[shape_name]
    fake = _fake_mesh(SIZES["2pod"])
    api = build_model(cfg, device="cpu")
    got = specs.build_all_specs(api, shape, fake, multi_pod=True)
    want = jspecs.build_all_specs(j_build_model(jcfg), shape, fake,
                                  multi_pod=True)
    assert set(got) == set(want)
    assert got["rules"] == want["rules"]
    _check_against_reference(
        cfg, dict(flatten_with_names(got["param_specs"])),
        dict(j_flatten(want["param_specs"])),
        lambda n, _: dict(flatten_with_names(got["param_part"]))[n],
        lambda n, _: _jflat(want["param_part"])[n])
    inputs = dict(flatten_with_names(got["inputs"]))
    jinputs = dict(j_flatten(want["inputs"]))
    if shape.kind != "decode":
        assert {n: (tuple(x.shape), x.dtype) for n, x in inputs.items()} == {
            n: (tuple(x.shape), _jdtype(x.dtype)) for n, x in jinputs.items()}
        assert {k: tuple(v) for k, v in got["batch_part"].items()} == {
            k: tuple(v) for k, v in want["batch_part"].items()}
    else:
        _same_by_name(dict(flatten_with_names(got["cache_part"])),
                      _jflat(want["cache_part"]))
    if shape.kind == "train":
        assert tuple(got["opt_part"]["step"]) == ()
        assert got["opt_specs"]["step"].dtype == torch.int32
        assert set(got["opt_part"]) == set(want["opt_part"])


def test_rules_context_and_named():
    mesh = pmesh.make_production_mesh(device="cpu")
    assert mesh.devices.shape == (16, 16) and mesh.size == 256
    assert mesh.shape == {"data": 16, "model": 16}
    assert {d.type for d in mesh.devices.flat} == {"cpu"}
    mp = pmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert mp.axis_names == ("pod", "data", "model")
    assert mp.devices.shape == (2, 16, 16)
    assert current_rules() == (None, None) and dispatch_shards() == 1
    with use_rules(mesh, lm_rules(False)):
        assert current_rules()[1] is mesh and dispatch_shards() == 16
        with use_rules(mp, lm_rules(True)):
            assert dispatch_shards() == 32
        assert dispatch_shards() == 16
    assert current_rules() == (None, None)
    tree = specs.named(mesh, {"a": PartitionSpec("data"),
                              "b": [PartitionSpec(), PartitionSpec(None)]})
    assert tree["a"] == NamedSharding(mesh, PartitionSpec("data"))
    assert tree["b"][1].spec == (None,)
    assert grid.grid_spec == ("grid",) and tuple(grid.replicated) == ()
    with pytest.raises(ValueError):
        pmesh.make_elastic_mesh(40, 16, device="cpu")


def test_default_mesh_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(configs.get_config("tinyllama-1.1b"))


def test_elastic_mesh_restores_and_trains(tmp_path):
    """``tests/test_elastic.py`` on a CPU mesh: a checkpoint written once,
    restored on a 64-shard (4, 16) mesh and then on the 48-shard (3, 16)
    one left after a host dies; the specs of each equal the reference's
    on a mesh of that shape, and one train_loss is finite."""
    cfg = configs.smoke_reduce(configs.get_config(
        "tinyllama-1.1b")).with_overrides(dtype="float32")
    jcfg = jconfigs.smoke_reduce(jconfigs.get_config(
        "tinyllama-1.1b")).with_overrides(dtype="float32")
    api = build_model(cfg, device="cpu")
    params = api.init_params(0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, params, blocking=True)
    batch = {"tokens": torch.zeros((8, 32), dtype=torch.int32),
             "labels": torch.zeros((8, 32), dtype=torch.int32),
             "mask": torch.ones((8, 32), dtype=torch.int32)}
    rules = lm_rules(multi_pod=False, fsdp=False)
    for n in (64, 48):
        mesh = pmesh.make_elastic_mesh(n, model_parallel=16, device="cpu")
        assert mesh.devices.size == n and mesh.devices.shape == (n // 16, 16)
        restored, step, _ = mgr.restore(params)
        assert step == 1
        with use_rules(mesh, rules):
            part = tree_partition_specs(api.param_specs(), rules, mesh)
            sharded = specs.named(mesh, part)
            loss, _ = api.train_loss(restored, batch)
        assert np.isfinite(float(loss)), (n, loss)
        _check_against_reference(
            cfg, dict(flatten_with_names(api.param_specs())),
            dict(j_flatten(j_build_model(jcfg).param_specs())),
            lambda name, _: dict(flatten_with_names(part))[name],
            lambda name, x: jparams.param_partition_spec(
                name, tuple(x.shape), jctx.lm_rules(False, False),
                {"data": n // 16, "model": 16}))
        assert all(isinstance(s, NamedSharding) and s.mesh is mesh
                   for _, s in flatten_with_names(sharded))
        for (_, a), (_, b) in zip(flatten_with_names(restored),
                                  flatten_with_names(params)):
            assert torch.equal(a, b)
