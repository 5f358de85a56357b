"""Port parity: the dry run and the roofline without a device
(``utils/cost.py``, ``launch/dryrun.py``, ``launch/roofline.py``).

* the roofline's arithmetic (``roofline_row``, ``markdown_table``,
  ``pick_hillclimb_cells``, ``model_flops``, ``active_param_count``,
  ``flash_kernel_traffic``) equals the reference's at the reference's
  constants, on records built here (the reference keeps its numbers
  under ``hlo_walk``, the port under ``cost``); no compile;
* at smoke size the counted prefill and train FLOPs equal the analytic
  count of the model's products (attention by formula);
* dry-run records, checked as ``tests/test_dryrun_integration.py``
  checks the reference's: ``tinyllama-1.1b x decode_32k x pod16x16`` and
  ``mamba2-780m x decode_32k x pod2x16x16``; ``gemma-7b x long_500k`` is
  a skip with its reason; the roofline CLI prints their table;
* ``n_params`` equals the reference's count from its ``param_specs``.
"""

import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.roofline as RR  # noqa: E402
from repro.configs import get_config as r_config  # noqa: E402
from repro.models import build_model as r_build  # noqa: E402
from repro.utils.tree import flatten_with_names as r_flatten  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig  # noqa: E402
from repro_torch.configs import get_config, smoke_reduce  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as TR  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils.cost import attention_pairs, count_flops  # noqa: E402
from repro_torch.utils.tree import flatten_with_names  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

REF_PEAKS = TR.Peaks(flops=RR.PEAK_FLOPS, hbm_bw=RR.HBM_BW,
                     link_bw=RR.LINK_BW, hbm_per_chip=RR.HBM_PER_CHIP)
CELLS = [("tinyllama-1.1b", "prefill_32k"), ("tinyllama-1.1b", "train_4k"),
         ("moonshot-v1-16b-a3b", "decode_32k"),
         ("whisper-medium", "prefill_32k"), ("mamba2-780m", "train_4k"),
         ("jamba-v0.1-52b", "long_500k"), ("gemma-7b", "long_500k")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread, as the other port test files: the driver runs
    six workers on this machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(i, arch, shape):
    """The same numbers in the reference's record layout and the port's
    (``error`` on one cell, the skip where the shape does not apply)."""
    rng = np.random.default_rng(i)
    nums = {"flops_per_device": float(rng.uniform(1e12, 1e15)),
            "mem_bytes_per_device": float(rng.uniform(1e9, 1e11)),
            "attn_interior_bytes": float(rng.uniform(0, 1e8)),
            "coll_link_bytes_per_device": float(rng.uniform(1e6, 1e10))}
    mem = {"argument_bytes": int(rng.integers(1e8, 2e10)),
           "temp_bytes": int(rng.integers(1e8, 2e10))}
    ok = not (shape == "long_500k" and arch == "gemma-7b")
    base = {"arch": arch, "shape": shape, "applicable": ok,
            "memory_analysis": mem, "compile_s": 1.5}
    if not ok:
        base["skip_reason"] = "long_500k needs sub-quadratic attention"
    if i == 3:
        base["error"] = "RuntimeError('boom')"
    return {**base, "hlo_walk": nums}, {**base, "cost": nums}


@pytest.fixture(scope="module")
def rows():
    out = []
    for i, (arch, shape) in enumerate(CELLS):
        for n_dev in (256, 512):
            ref, port = _records(i, arch, shape)
            out.append((RR.roofline_row(ref, n_devices=n_dev),
                        TR.roofline_row(port, n_devices=n_dev,
                                        peaks=REF_PEAKS)))
    return out


def test_roofline_rows_equal_the_reference(rows):
    for r, t in rows:
        assert t == r


def test_table_and_picks_equal_the_reference(rows):
    ref = [r for r, _ in rows]
    port = [t for _, t in rows]
    assert TR.markdown_table(port) == RR.markdown_table(ref)
    assert TR.pick_hillclimb_cells(port) == RR.pick_hillclimb_cells(ref)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_and_kernel_traffic_equal_the_reference(arch, shape):
    rc, tc = r_config(arch), get_config(arch)
    assert TR.active_param_count(tc) == RR.active_param_count(rc)
    assert TR.model_flops(tc, SHAPES[shape]) == RR.model_flops(
        rc, RR.SHAPES[shape])
    for n_dev in (256, 512):
        assert TR.flash_kernel_traffic(tc, SHAPES[shape], n_dev) == \
            RR.flash_kernel_traffic(rc, RR.SHAPES[shape], n_dev)


def _reference_n_params(arch):
    return sum(int(np.prod(x.shape)) for _, x in
               r_flatten(r_build(r_config(arch)).param_specs()))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_n_params_equals_the_reference(arch):
    port = sum(int(np.prod(x.shape)) for _, x in flatten_with_names(
        build_model(get_config(arch), device="cpu").param_specs()))
    assert port == _reference_n_params(arch)


def _analytic(cfg, b, s, kind):
    """Products of a dense SwiGLU model, 2 m n k each: per token and
    layer the q, k, v, o projections and the three MLP matrices; the
    head on the last position (prefill) or every position (train);
    attention 4 hd per causal (query, key) pair and query head.  Train:
    forward, the layers' recompute (remat of every layer; the checkpoint
    stops once it has the tensors the backward saved, so the MLP's output
    product is not rerun), and a backward of twice the forward."""
    d, h, kv, hd, f, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.resolved_head_dim(), cfg.d_ff, cfg.vocab_size)
    layer = b * s * (2 * d * h * hd + 4 * d * kv * hd + 2 * h * hd * d
                     + 6 * d * f)
    attn = 4 * hd * b * h * attention_pairs(s, s, True)
    L = cfg.n_layers
    if kind == "prefill":
        return L * (layer + attn) + 2 * b * d * V
    out_product = b * s * 2 * f * d
    return L * (4 * (layer + attn) - out_product) + 3 * 2 * b * s * d * V


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_smoke_counts_equal_the_analytic_count(kind):
    cfg = smoke_reduce(get_config("tinyllama-1.1b"))
    assert cfg.mlp_type == "swiglu" and cfg.remat_policy != "none"
    shape = ShapeConfig("smoke", seq_len=64, global_batch=2, kind=kind)
    got = count_flops(build_model(cfg, device="cpu"), shape)
    assert got["flops"] == _analytic(cfg, 2, 64, kind)


def test_dryrun_records_and_roofline_cli(tmp_path):
    cells = [("tinyllama-1.1b", "decode_32k", []),
             ("mamba2-780m", "decode_32k", ["--multi-pod"]),
             ("gemma-7b", "long_500k", [])]
    for arch, shape, extra in cells:
        dryrun.main(["--arch", arch, "--shape", shape, "--out",
                     str(tmp_path), "--tag", "test", *extra])
    for arch, shape, mp in (("tinyllama-1.1b", "decode_32k", False),
                            ("mamba2-780m", "decode_32k", True)):
        mesh = "pod2x16x16" if mp else "pod16x16"
        with open(tmp_path / f"{arch}__{shape}__{mesh}__test.json") as fh:
            rec = json.load(fh)
        assert rec["applicable"] and "error" not in rec
        assert rec["n_devices"] == (512 if mp else 256)
        assert rec["n_params"] == _reference_n_params(arch)
        assert rec["cost"]["flops_per_device"] > 0
        assert rec["cost"]["mem_bytes_per_device"] > 0
        assert rec["memory_analysis"]["argument_bytes"] > 0
        assert rec["memory_analysis"]["temp_bytes"] is None
        assert rec["memory_analysis"]["temp_bytes_reason"]
        assert "coll_link_bytes_per_device" in rec["cost"]
    with open(tmp_path / "gemma-7b__long_500k__pod16x16__test.json") as fh:
        rec = json.load(fh)
    assert rec["applicable"] is False
    assert "sub-quadratic" in rec["skip_reason"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        TR.main(["--dir", str(tmp_path), "--tag", "test"])
    lines = out.getvalue().splitlines()
    assert any(line.startswith("| tinyllama-1.1b | decode_32k |")
               for line in lines)
    assert any("| gemma-7b | long_500k |" in line and "SKIP" in line
               for line in lines)
