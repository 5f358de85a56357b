"""Quickstart on the PyTorch port: the paper's experiment.

Builds the four JSCC systems, submits the NPB class-D suite simultaneously,
sweeps the K parameter, and prints the energy/runtime trade-off (paper
Figs 1-2) plus the placements.  The port of ``examples/quickstart.py``;
it prints the same lines.

    PYTHONPATH=src python examples/torch_quickstart.py              # CUDA
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.core import JSCC_SYSTEMS, SimConfig, make_npb_workload, sweep_k


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    w = make_npb_workload(JSCC_SYSTEMS)
    ks = np.array([0.0, 0.05, 0.10, 0.20, 0.50, 0.85])
    res = sweep_k(w, SimConfig(mode="paper", warm_start=True), ks,
                  device=args.device)

    E = res["total_energy"].cpu().numpy()
    M = res["makespan"].cpu().numpy()
    sel = res["system"].cpu().numpy()
    names = w.systems

    print("EcoSched quickstart — NPB BT/EP/IS/LU/SP on KNL/BDW/SKX/CLK")
    print(f"{'K':>5} {'energy':>10} {'dE%':>7} {'runtime':>9} {'dT%':>7}  placements")
    for i, k in enumerate(ks):
        placem = ",".join(names[s][:3] for s in sel[i])
        print(f"{int(k*100):4d}% {E[i]/1e3:9.1f}kJ {100*(E[i]-E[0])/E[0]:+6.1f}% "
              f"{M[i]:8.1f}s {100*(M[i]-M[0])/M[0]:+6.1f}%  {placem}")

    i10 = list(ks).index(0.20)
    print("\npaper claim: ~21.5% energy reduction at ~3.8% runtime increase")
    print(f"ours (K=20%): {100*(E[i10]-E[0])/E[0]:+.1f}% energy, "
          f"{100*(M[i10]-M[0])/M[0]:+.1f}% runtime")


if __name__ == "__main__":
    main()
