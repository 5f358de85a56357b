"""Roofline analysis over the port's dry-run records
(``repro/launch/roofline.py``), at the H100's peaks.

Terms per (arch x shape) cell, from the dry-run record's ``cost``:
    t_compute    = flops_per_device   / peaks.flops     (989 TF/s bf16)
    t_memory     = mem_bytes_per_dev  / peaks.hbm_bw    (3.35 TB/s)
    t_collective = coll_link_bytes    / peaks.link_bw   (450 GB/s)

The peaks are NVIDIA's datasheet figures for one H100 SXM 80GB (dense
bf16 without sparsity, HBM3, NVLink 4 per direction, HBM capacity), not
measurements, and they assume the card's full 700 W power limit.  A mesh
axis of 16 cards (the production mesh's 'model' axis) spans two 8-card
NVLink domains, so its collectives cross the slower inter-node network
for part of the ring: ``t_collective`` is then a lower bound.

flops / bytes / collective bytes come from ``utils/cost.py``'s
first-order count (see its docstring); ``roofline_row`` takes the
constants as ``peaks=`` so its arithmetic can run at any card's figures.

MODEL_FLOPS (the useful-work yardstick):
    train    6 * N_active * tokens        (+ attention term, reported apart)
    prefill  2 * N_active * tokens
    decode   2 * N_active * batch
N_active excludes embeddings/positions and counts MoE experts at top_k/E.

    python -m repro_torch.launch.roofline --dir DIR [--mesh pod2x16x16]
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass

import numpy as np

from repro_torch.configs import SHAPES, get_config
from repro_torch.models import build_model
from repro_torch.utils.tree import flatten_with_names


@dataclass(frozen=True)
class Peaks:
    """One card's peak rates and memory: FLOP/s, HBM bytes/s, link
    bytes/s a direction, HBM bytes."""
    flops: float
    hbm_bw: float
    link_bw: float
    hbm_per_chip: float


#: NVIDIA H100 SXM 80GB datasheet figures (not measured): 989e12 dense
#: bf16 FLOP/s, 3.35e12 B/s HBM3, 450e9 B/s NVLink 4 a direction, 80e9 B.
H100 = Peaks(flops=989e12, hbm_bw=3.35e12, link_bw=450e9, hbm_per_chip=80e9)

MODEL_PARALLEL = 16      # the production mesh's 'model' axis


def active_param_count(cfg) -> tuple[int, int]:
    """(N_total_nonembed, N_active_nonembed) from the param spec tree."""
    specs = build_model(cfg, device="cpu").param_specs()
    total = active = 0
    moe_scale = (cfg.moe.top_k / cfg.moe.n_experts) if cfg.moe.n_experts \
        else 1.0
    for name, x in flatten_with_names(specs):
        n = int(np.prod(x.shape))
        top = name.split("/")[0]
        if top in ("embed", "head") or name.endswith(("enc_pos", "dec_pos")):
            continue
        total += n
        if "/moe/w" in name:
            active += int(n * moe_scale)
        else:
            active += n
    return total, active


def model_flops(cfg, shape) -> float:
    _, n_active = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch          # decode: 1 token/seq


def load_records(dryrun_dir: str, mesh: str = "pod16x16", tag: str = ""):
    recs = {}
    suffix = f"__{tag}" if tag else ""
    for path in glob.glob(os.path.join(dryrun_dir,
                                       f"*__{mesh}{suffix}.json")):
        with open(path) as fh:
            rec = json.load(fh)
        if tag == "" and rec.get("arch") and "__" in os.path.basename(path):
            parts = os.path.basename(path)[:-5].split("__")
            if len(parts) != 3:      # skip tagged variants
                continue
        recs[(rec["arch"], rec["shape"])] = rec
    return recs


def flash_kernel_traffic(cfg, shape, n_devices: int = 256) -> float:
    """Analytic HBM bytes/device of the flash attention kernel (Q, K, V
    streamed + O written; K/V re-read per q-block is second-order and
    folded into the pass factor).  Replaces the record's attention
    streams in the kernel-adjusted memory term."""
    if cfg.n_heads == 0 or shape.kind == "decode":
        return 0.0
    n_attn = len(cfg.attn_layer_ids())
    if cfg.is_encoder_decoder:
        n_attn = cfg.n_encoder_layers + 2 * cfg.n_layers
    mp = MODEL_PARALLEL
    h_loc = cfg.n_heads // mp if cfg.n_heads % mp == 0 else cfg.n_heads
    kv_loc = (cfg.n_kv_heads // mp
              if cfg.n_kv_heads % mp == 0 else cfg.n_kv_heads)
    dp = n_devices // mp
    b_loc = max(1, shape.global_batch // dp)
    passes = 4.0 if shape.is_training else 1.0   # fwd + remat-fwd + bwd(~2x)
    hd = cfg.resolved_head_dim()
    return (passes * n_attn * b_loc * shape.seq_len
            * (2 * h_loc + 2 * kv_loc) * hd * 2.0)


def roofline_row(rec, n_devices: int = 256, *, peaks: Peaks = H100) -> dict:
    arch, shape_name = rec["arch"], rec["shape"]
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not rec.get("applicable", False):
        return {"arch": arch, "shape": shape_name,
                "skip": rec.get("skip_reason", "")}
    if "error" in rec:
        return {"arch": arch, "shape": shape_name, "error": rec["error"]}
    cost = rec["cost"]
    t_c = cost["flops_per_device"] / peaks.flops
    t_m = cost["mem_bytes_per_device"] / peaks.hbm_bw
    # kernel-adjusted memory: the flash kernel keeps its tiles in shared
    # memory; replace the record's attention streams with the kernel's
    # Q/K/V/O traffic at the mesh's per-device shapes
    attn_interior = cost.get("attn_interior_bytes", 0.0)
    mem_adj = (cost["mem_bytes_per_device"] - attn_interior
               + flash_kernel_traffic(cfg, shape, n_devices))
    t_m_adj = mem_adj / peaks.hbm_bw
    t_x = cost["coll_link_bytes_per_device"] / peaks.link_bw
    dom = max(("compute", t_c), ("memory", t_m_adj), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape)
    total = cost["flops_per_device"] * n_devices
    bound = max(t_c, t_m_adj, t_x)
    mem = rec["memory_analysis"]
    # temp_bytes is null in the port's records (nothing compiled): the
    # footprint is then the arguments alone, a lower bound
    hbm_gb = (mem["argument_bytes"] + (mem["temp_bytes"] or 0)) / 1e9
    return {
        "arch": arch, "shape": shape_name,
        "t_compute": t_c, "t_memory": t_m, "t_memory_adj": t_m_adj,
        "t_collective": t_x,
        "dominant": dom,
        "model_flops": mf,
        "hlo_flops_total": total,           # the reference's key: counted total
        "useful_ratio": mf / total if total else 0.0,
        # useful work rate vs peak if perfectly compute-bound
        "roofline_frac": ((mf / (n_devices * peaks.flops)) / bound
                          if bound else 0.0),
        "step_time_bound_s": bound,
        "hbm_gb_per_device": hbm_gb,
        "fits_hbm": hbm_gb <= peaks.hbm_per_chip / 1e9,
        "compile_s": rec.get("compile_s"),
    }


def improvement_note(row) -> str:
    if "skip" in row or "error" in row:
        return ""
    d = row["dominant"]
    if d == "collective":
        return ("reduce TP collective volume: fewer all-reduces per layer "
                "(sequence-parallel residuals / a model axis inside one "
                "8-card NVLink domain / overlap with compute)")
    if d == "memory":
        return ("cut HBM traffic: keep attention tiles in shared memory "
                "(the flash kernel), fuse elementwise work into the "
                "products, a tighter remat policy")
    return ("raise tensor-core utilization: larger per-card tiles, bf16 "
            "wgmma products instead of widened f32 GEMMs, fewer pad ops")


def markdown_table(rows) -> str:
    hdr = ("| arch | shape | t_comp (s) | t_mem raw (s) | t_mem adj (s) | "
           "t_coll (s) | dominant | MODEL_FLOPS | useful/HLO | roofline frac | "
           "HBM GB/dev | fits |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        if "skip" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                         f"SKIP | — | — | — | — | {r['skip'][:60]} |")
            continue
        if "error" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                         f"ERROR | — | — | — | — | {r['error'][:60]} |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute']:.3f} | "
            f"{r['t_memory']:.3f} | {r['t_memory_adj']:.3f} | "
            f"{r['t_collective']:.3f} | {r['dominant']} | "
            f"{r['model_flops']:.3g} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_frac']:.3f} | {r['hbm_gb_per_device']:.1f} | "
            f"{'y' if r['fits_hbm'] else 'NO'} |")
    return hdr + "\n".join(lines) + "\n"


def pick_hillclimb_cells(rows):
    """worst roofline fraction, most collective-bound."""
    ok = [r for r in rows if "skip" not in r and "error" not in r]
    worst = min(ok, key=lambda r: r["roofline_frac"])
    coll = max(ok, key=lambda r: r["t_collective"]
               / max(r["step_time_bound_s"], 1e-9))
    return worst, coll


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="roofline over dry-run records at the H100's datasheet "
                    "peaks")
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    n_devices = 512 if args.mesh == "pod2x16x16" else 256
    recs = load_records(args.dir, args.mesh, args.tag)
    rows = [roofline_row(r, n_devices=n_devices)
            for (a, s), r in sorted(recs.items())]
    print(markdown_table(rows))
    ok = [r for r in rows if "skip" not in r and "error" not in r]
    if ok:
        worst, coll = pick_hillclimb_cells(rows)
        print(f"\nworst roofline frac: {worst['arch']} x {worst['shape']} "
              f"({worst['roofline_frac']:.3f})")
        print(f"most collective-bound: {coll['arch']} x {coll['shape']}")


if __name__ == "__main__":
    main()
