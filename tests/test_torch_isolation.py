"""The port stands alone: no module of ``repro_torch`` (and not
``chip_smoke.py``, ``campaign_ab.py`` or the port's examples) imports JAX
or the reference package, the entry points never fall back to the CPU by
themselves, the event-core and campaign-scale options run, and options
outside the ported slice are refused explicitly."""

import ast
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import (policy_from_reference,  # noqa: E402
                                 workload_from_reference)
from repro_torch.core import JSCC_SYSTEMS, Scheduler  # noqa: E402
from repro_torch.core import make_npb_workload, make_policy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_port_module_loads_no_jax_or_reference():
    assert "repro_torch.core.events" in set(_modules())
    code = ("import sys\n"
            f"for m in {list(_modules())!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", [*sorted(PKG.rglob("*.py")),
                                  ROOT / "chip_smoke.py",
                                  ROOT / "campaign_ab.py",
                                  *sorted(ROOT.glob("examples/torch_*.py"))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scheduler().run(make_npb_workload(JSCC_SYSTEMS))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scheduler("paper", device="cuda")
    res = Scheduler(device="cpu").run(make_npb_workload(JSCC_SYSTEMS))
    assert res.total_energy.device.type == "cpu"


def test_workloads_default_to_cuda_and_never_fall_back(monkeypatch):
    from repro_torch.workloads import (BENCHMARKS, run_benchmark, run_cfd,
                                       run_ep, run_is)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in BENCHMARKS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_benchmark(name, "smoke")
    for run in (run_ep, run_is, run_cfd):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()
    _, ok, _ = run_benchmark("IS", "smoke", device="cpu")
    assert ok


def test_models_default_to_cuda_and_never_fall_back(monkeypatch):
    from repro_torch.configs import get_config, smoke_reduce
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.transformer import init_decode_cache, init_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("tinyllama-1.1b", "qwen2-1.5b", "gemma-7b",
                 "internlm2-20b"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(get_config(arch))
    small = smoke_reduce(get_config("tinyllama-1.1b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(small, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_decode_cache(small, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "tinyllama-1.1b", "--reduced"])
    api = build_model(smoke_reduce(get_config("tinyllama-1.1b")),
                      device="cpu")
    assert api.device.type == "cpu"
    assert api.init_params(0)["embed"]["table"].device.type == "cpu"


@pytest.mark.parametrize("arch,item", [
    ("llama4-scout-17b-a16e", "item 14c"), ("moonshot-v1-16b-a3b", "item 14c"),
    ("jamba-v0.1-52b", "item 14c"),
    ("whisper-medium", "item 14d"), ("phi-3-vision-4.2b", "item 14d")])
def test_unported_model_families_raise(monkeypatch, arch, item):
    """The five families that the port refused until ROADMAP Queue 1
    ``item`` was done now build and run a reduced prefill with
    ``device="cpu"``, and without it default to CUDA, raising without a
    card (never falling back to the CPU)."""
    from repro_torch.configs import get_config, smoke_reduce
    from repro_torch.models import build_model, encdec, transformer
    cfg = smoke_reduce(get_config(arch))
    api = build_model(cfg, device="cpu")
    params = api.init_params(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32))}
    if cfg.is_encoder_decoder:
        batch["frame_embeds"] = torch.randn(2, cfg.encoder_seq, cfg.d_model)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.randn(2, cfg.n_patches, cfg.d_model)
    logits = api.prefill(params, batch)
    assert logits.shape == (2, cfg.vocab_size), item
    assert bool(torch.isfinite(logits).all()), item
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = encdec if cfg.is_encoder_decoder else transformer
    for c in (get_config(arch), cfg):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(c)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            module.init_params(c, 0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            module.init_decode_cache(c, 1, 8)


def test_ssm_serving_imports_no_jax_and_never_falls_back(monkeypatch):
    """The Mamba-2 modules and the SSD scan kernel load no JAX or
    ``repro`` module, and mamba2-780m defaults to CUDA, raising without a
    card."""
    code = ("import sys\n"
            "import repro_torch.models.mamba, repro_torch.kernels.ssd_scan\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    from repro_torch.configs import get_config, smoke_reduce
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.transformer import init_decode_cache, init_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("mamba2-780m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    for fn in (lambda c: init_params(c, 0),
               lambda c: init_decode_cache(c, 1, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(smoke_reduce(cfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "mamba2-780m", "--reduced"])
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_params_from_reference_imports_nothing_of_the_reference():
    """The parameter converter is duck-typed over plain dicts of numpy
    arrays: converting a reference-shaped tree loads no JAX and no
    ``repro`` module."""
    code = """
import sys
import numpy as np
from repro_torch.configs import get_config, smoke_reduce
from repro_torch.convert import params_from_reference
cfg = smoke_reduce(get_config("qwen2-1.5b"))
d, h, kv, hd, f, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.resolved_head_dim(), cfg.d_ff, cfg.vocab_size,
                         cfg.n_layers)
z = lambda *s: np.arange(np.prod(s), dtype=np.float32).reshape(s)
tree = {"embed": {"table": z(V, d)}, "head": {},
        "final_norm": {"scale": z(d)},
        "groups": {"pos0": {
            "norm1": {"scale": z(L, d)}, "norm2": {"scale": z(L, d)},
            "attn": {"wq": z(L, d, h, hd), "wk": z(L, d, kv, hd),
                     "wv": z(L, d, kv, hd), "wo": z(L, h, hd, d),
                     "bq": z(L, h, hd), "bk": z(L, kv, hd),
                     "bv": z(L, kv, hd)},
            "mlp": {"wi": z(L, d, f), "wu": z(L, d, f), "wo": z(L, f, d)}}}}
p = params_from_reference(cfg, tree)
assert len(p["layers"]) == L
assert (p["layers"][2]["attn"]["wq"].numpy() == tree["groups"]["pos0"]["attn"]["wq"][2]).all()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("kwargs", [{"queue": "easy_backfill"},
                                    {"policy": "easy_queue_aware"}])
def test_easy_options_run_on_the_cpu(kwargs):
    """EASY backfilling (ROADMAP item 4) is ported: both spellings run."""
    w = make_npb_workload(JSCC_SYSTEMS, repeats=3)
    res = Scheduler(device="cpu", warm_start=True, **kwargs).run(w)
    assert res.system.shape == (15,) and res.backfilled.dtype == torch.bool
    assert bool(torch.isfinite(res.finish).all())


@pytest.mark.parametrize("kwargs", [
    {"policy": "easy_backfill", "engine": "events"},
    {"queue": "conservative:window=4"},
    {"policy": "conservative"},
    {"power_cap": 50_000.0},
    {"power_cap": [np.inf, 40_000.0]},
    {"engine": "events"},
])
def test_event_core_options_run_on_the_cpu(kwargs):
    """The event-granular core and conservative backfilling (ROADMAP items
    5 and 6) are ported: each option runs, on the event clock, which
    reports the SCC's peak draw."""
    w = make_npb_workload(JSCC_SYSTEMS, repeats=3)
    res = Scheduler(device="cpu", warm_start=True, **kwargs).run(w)
    assert res.system.shape[-1] == 15
    assert bool(torch.isfinite(res.finish).all())
    assert bool(torch.isfinite(res.peak_power).all())


@pytest.mark.parametrize("kwargs,item", [
    ({"easy_eval": "unrolled"}, "item 15"),
    ({"shards": "auto"}, "item 7"),
    ({"chunk": 1024}, "item 7"),
])
def test_unported_options_raise(kwargs, item):
    """Options by ROADMAP item: item 15 is not ported and raises naming
    it; item 7 (campaign scale) is, so ``shards`` and ``chunk`` run and
    equal the run without them."""
    if item != "item 7":
        with pytest.raises(NotImplementedError, match=item):
            Scheduler(device="cpu", **kwargs)
        return
    w = make_npb_workload(JSCC_SYSTEMS, repeats=3)
    pol = make_policy("paper", k=np.array([0.0, 0.2], np.float32))
    base = Scheduler(pol, device="cpu", seeds=[0, 1]).run(w)
    res = Scheduler(pol, device="cpu", seeds=[0, 1], **kwargs).run(w)
    for f in ("system", "start", "finish", "energy", "total_energy",
              "makespan", "C_tab", "T_tab", "runs"):
        assert torch.equal(getattr(res, f), getattr(base, f)), f


@pytest.mark.parametrize("kwargs", [{"placer": "pallas"},
                                    {"placer": "pallas_interpret"},
                                    {"engine": "bogus"}])
def test_bad_options_raise_value_error(kwargs):
    with pytest.raises(ValueError):
        Scheduler(device="cpu", **kwargs)


def test_reference_state_converts_duck_typed():
    """The converters take any object with the reference's fields, so the
    port never imports the reference to read its state."""
    w = make_npb_workload(JSCC_SYSTEMS)
    ns = SimpleNamespace(**{f.name: getattr(w, f.name)
                            for f in dataclasses.fields(w)})
    back = workload_from_reference(ns)
    for f in dataclasses.fields(w):
        a, b = getattr(w, f.name), getattr(back, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    pol = make_policy("ucb", k=np.array([0.0, 0.1], np.float32))
    ns = SimpleNamespace(**{f.name: getattr(pol, f.name)
                            for f in dataclasses.fields(pol)})
    out = policy_from_reference(ns)
    assert out.exploration == "optimistic_bound"
    np.testing.assert_array_equal(out.k, pol.k)


@pytest.mark.slow
def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA the chip script exits non-zero and prints no result,
    both in the repository and alone in an empty directory."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)], env=env,
                              cwd=script.parent, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_service_defaults_to_cuda_and_loads_no_jax(monkeypatch):
    """The online service (dispatcher, what-if, checkpoints, the JSONL
    CLI) loads no JAX or ``repro`` module, and its sessions default to
    CUDA, raising without a card."""
    code = ("import sys\n"
            "import repro_torch.service, repro_torch.checkpoint\n"
            "import repro_torch.service.pool, repro_torch.service.writer\n"
            "import repro_torch.launch.scheduler_service\n"
            "import repro_torch.utils.tree\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    from repro_torch.launch import scheduler_service
    from repro_torch.service import Dispatcher
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = make_npb_workload(JSCC_SYSTEMS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Dispatcher(w)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Dispatcher.from_scheduler(Scheduler(), w)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scheduler_service.main([])
    assert Dispatcher(w, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("case", ["cli_pool_on_cpu", "replicate_on_cuda"])
def test_service_pool_runs_on_cpu_and_defaults_to_cuda(case, capsys,
                                                       monkeypatch):
    """The session pool: ``--pool 2 --device cpu`` serves a request of
    the ``{"session": i}`` envelope on the CPU; ``SessionPool.replicate``
    of a default scheduler raises without a card, naming
    ``device='cpu'``."""
    from repro_torch.launch import scheduler_service
    from repro_torch.service import SessionPool
    if case == "cli_pool_on_cpu":
        req = {"op": "submit", "session": 1, "prog": "BT", "arrival": 0.0}
        monkeypatch.setattr(sys, "stdin", io.StringIO(
            json.dumps(req) + "\n"))
        scheduler_service.main(["--pool", "2", "--device", "cpu",
                                "--capacity", "4"])
        out = capsys.readouterr().out.splitlines()
        assert [json.loads(line) for line in out] == [
            {"ok": True, "session": 1, "job": 0, "now": 0.0}]
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        w = make_npb_workload(JSCC_SYSTEMS)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SessionPool.replicate(Scheduler(), 2, w)


def test_training_loads_no_jax_and_never_falls_back(monkeypatch, tmp_path):
    """The training modules (the synthetic stream, the optimizer, the step
    and loop, the launcher) load no JAX or ``repro`` module; the model's
    ``train_loss``, ``device_batch``, the stream and ``launch.train``
    default to CUDA and raise without a card."""
    code = ("import sys\n"
            "import repro_torch.data.synthetic, repro_torch.optim\n"
            "import repro_torch.train, repro_torch.launch.train\n"
            "import repro_torch.kernels.autograd\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    from repro_torch.configs import get_config, smoke_reduce
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticStream, device_batch
    from repro_torch.launch import train
    from repro_torch.models import build_model
    small = smoke_reduce(get_config("tinyllama-1.1b"))
    shape = ShapeConfig("t", seq_len=16, global_batch=2, kind="train")
    api = build_model(small, device="cpu")
    loss, metrics = api.train_loss(api.init_params(0),
                                   device_batch(small, shape, 0, "cpu"))
    assert loss.device.type == "cpu" and sorted(metrics) == [
        "aux", "loss", "tokens"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg in (get_config("tinyllama-1.1b"), small):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg).train_loss
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_batch(small, shape, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticStream(small, shape)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("example", ["torch_serve_demo", "torch_train_smoke"])
def test_lm_examples_run_on_the_cpu_and_default_to_cuda(example, monkeypatch,
                                                        capsys):
    """The serve and train examples run with ``--device cpu`` (the train
    one crashes on purpose and resumes) and raise without a card."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        example, ROOT / "examples" / f"{example}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = (["--tokens", "4"] if example == "torch_serve_demo"
            else ["--steps", "4", "--batch", "2", "--seq", "16",
                  "--microbatches", "1"])
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        mod.main([*argv, "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    if example == "torch_serve_demo":
        assert "decoded 4 tokens x batch 4" in out and "on CPU" in out
    else:
        assert "injected crash at step 2" in out
        assert "steps=4 resumed_from=2 on cpu" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)


def test_sharding_and_data_parallel_refuse_nothing(monkeypatch):
    """The sharding modules, the meshes, the specs and the data-parallel
    trainer load no JAX or ``repro`` module and refuse no option of the
    reference's: every arch's ``param_specs`` / ``input_specs`` build, the
    (pod, data) trainer runs compressed and not; the meshes and
    ``build_model`` default to CUDA and raise without a card."""
    code = ("import sys\n"
            "import repro_torch.sharding, repro_torch.sharding.grid\n"
            "import repro_torch.sharding.params, repro_torch.launch.specs\n"
            "import repro_torch.train.dp, repro_torch.optim.compression\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    from repro_torch.launch.mesh import (_make_mesh, make_elastic_mesh,
                                         make_production_mesh)
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_dp_state, make_dp_train_step
    for arch in ARCH_IDS:
        api = build_model(get_config(arch), device="cpu")
        assert api.param_specs() and api.input_specs(SHAPES["train_4k"])
    mesh = _make_mesh((2, 1), ("pod", "data"), device="cpu")
    p = {"w": torch.ones(3)}
    for compress in (True, False):
        step = make_dp_train_step(lambda q, b: (q["w"] * b["x"]).sum(),
                                  mesh, AdamWConfig(), compress)
        out = step(p, *init_dp_state(p), {"x": torch.ones((2, 3))})
        assert torch.isfinite(out[3])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: _make_mesh((2, 2), ("pod", "data")),
                 make_production_mesh, lambda: make_elastic_mesh(32),
                 lambda: build_model(get_config("tinyllama-1.1b"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
