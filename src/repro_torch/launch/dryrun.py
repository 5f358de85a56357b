"""Multi-pod dry run without a device (``repro/launch/dryrun.py``).

Every (arch x shape x mesh) cell is set up as a launch would set it up:
the model's parameters, optimizer state and inputs as ``meta`` tensors
(``build_all_specs``), their partition specs on the production mesh
(``make_production_mesh(device="cpu")``: (data 16, model 16) or (pod 2,
data 16, model 16) shards), and one step of the cell's kind counted by
``utils.cost.cell_cost``: FLOPs, HBM bytes and collective link bytes per
device.  Nothing is compiled or run, and no device is asked for, so the
whole matrix runs on a machine with no card.

A record (``{arch}__{shape}__{mesh}[__{tag}].json``) keeps the keys the
roofline reads: ``n_params``, ``memory_analysis.argument_bytes`` (per
shard: parameters, optimizer state and inputs) and under ``cost``
``flops_per_device``, ``mem_bytes_per_device``, ``attn_interior_bytes``
and ``coll_link_bytes_per_device``.  ``memory_analysis.temp_bytes`` is
null: without a compiler there is nothing to ask for the working set
short of running the step.  A cell the shape does not apply to is
recorded as a skip with its reason (``shape_applicable``).

    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape decode_32k --out DIR [--multi-pod | --both-meshes]
    python -m repro_torch.launch.dryrun --all --both-meshes --out DIR
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_all_specs
from repro_torch.models import build_model
from repro_torch.utils.cost import cell_cost
from repro_torch.utils.tree import flatten_with_names

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")

TEMP_BYTES_REASON = ("no compiler to ask: the working set is known only "
                     "by running the step")


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             overrides: dict | None = None) -> dict:
    """Count one (arch x shape x mesh) cell; return the record."""
    t_all = time.time()
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    ok, reason = shape_applicable(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "n_devices": 512 if multi_pod else 256,
        "applicable": ok,
    }
    if not ok:
        rec["skip_reason"] = reason
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    api = build_model(cfg, device="cpu")
    sp = build_all_specs(api, shape, mesh, multi_pod=multi_pod)
    rec["n_params"] = int(sum(np.prod(x.shape) for _, x in
                              flatten_with_names(sp["param_specs"])))
    t0 = time.time()
    cost = cell_cost(api, shape, sp, mesh)
    rec["count_s"] = round(time.time() - t0, 2)
    rec["memory_analysis"] = {"argument_bytes": cost.pop("argument_bytes"),
                              "temp_bytes": None,
                              "temp_bytes_reason": TEMP_BYTES_REASON}
    rec["cost"] = cost
    rec["total_s"] = round(time.time() - t_all, 2)
    return rec


def _parse_overrides(pairs) -> dict:
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if v in ("true", "false"):
            v = v == "true"
        elif v.replace(".", "", 1).isdigit():
            v = float(v) if "." in v else int(v)
        overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry run (no device)")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) on the selected mesh(es)")
    ap.add_argument("--out", default=os.path.normpath(DEFAULT_OUT))
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides key=value (e.g. remat_policy=dots)")
    ap.add_argument("--tag", default="", help="suffix for output files")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.override)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        archs, shapes = list(ARCH_IDS), list(SHAPES)
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    t_all = time.time()
    for a, s, mp in cells:
        mesh_name = "pod2x16x16" if mp else "pod16x16"
        tag = f"__{args.tag}" if args.tag else ""
        path = os.path.join(args.out, f"{a}__{s}__{mesh_name}{tag}.json")
        try:
            rec = run_cell(a, s, multi_pod=mp, overrides=overrides or None)
            status = ("SKIP" if not rec.get("applicable")
                      else f"ok count={rec['count_s']}s")
        except Exception as e:   # noqa: BLE001 — record and continue
            rec = {"arch": a, "shape": s, "mesh": mesh_name,
                   "error": repr(e), "traceback": traceback.format_exc()}
            status = f"FAIL {e!r}"
            failures += 1
        with open(path, "w") as fh:
            json.dump(rec, fh, indent=1)
        print(f"[dryrun] {a:24s} {s:12s} {mesh_name:11s} {status}",
              flush=True)
    print(f"[dryrun] {len(cells)} cells in {time.time() - t_all:.1f}s",
          flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
