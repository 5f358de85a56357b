"""DVFS frequency tiers: the per-tier tables of the (system x tier)
candidate axis.

A frequency multiplier phi stretches the compute phase and scales its
dynamic power by ~phi^3 (voltage tracks frequency); idle, network and disk
draw are unchanged.  Per tier and the phase model::

    T(phi) = T + T_comp * (1/phi - 1)
    E(phi) = E + E_comp * (phi^2 - 1) + n_req * idle_w * T_comp * (1/phi - 1)

The unit tier's entries are the base tables bit for bit.  ``tier_tables``
runs on float32 tensors (the engine); ``tier_tables_py`` is its float64
numpy twin (the differential mirror); the table helpers stay numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.workload_model import NPB_PROFILES, predict_phases
from repro_torch.utils.fp import fma

_TINY = 1e-30


def phase_split(w) -> tuple:
    """``(T_comp, E_comp)`` float64 [P, S] for a ``Workload``: its explicit
    phase split when present, else the default for trace/stream workloads
    (all runtime compute-phase, every non-idle joule dynamic)."""
    T = np.asarray(w.T_true, np.float64)
    E = np.asarray(w.E_true, np.float64)
    Tc = T if w.T_comp is None else np.asarray(w.T_comp, np.float64)
    if w.E_comp is not None:
        Ec = np.asarray(w.E_comp, np.float64)
    else:
        idle = (np.zeros(len(w.n_nodes)) if w.idle_w is None
                else np.asarray(w.idle_w, np.float64))
        Ec = np.maximum(E - np.asarray(w.n_req, np.float64) * idle[None, :]
                        * T, 0.0)
    return Tc, Ec


def _tier_model(T, E, C, w_pow, Tc, Ec, n_idle, phi):
    """Per-tier table math on float32 tensors; inputs [P, 1, S] except
    ``phi`` [1, F, 1].  ``where(phi == 1)`` makes unit tiers the base
    values exactly.  Rounding follows the reference's compiled graph:
    the multiply-adds of ``T`` and ``E`` are fused (one rounding each),
    while the runtime inside the watts table is the unfused
    ``T + stretch`` (the compiler recomputes it there)."""
    unit = phi == 1.0
    stretch = Tc * (1.0 / phi - 1.0)
    T_f = torch.where(unit, T, fma(Tc, 1.0 / phi - 1.0, T))
    E_f = torch.where(unit, E, fma(n_idle, stretch,
                                   fma(Ec, phi * phi - 1.0, E)))
    r_t = torch.where(unit, 1.0, T_f / torch.clamp_min(T, _TINY))
    r_c = torch.where(unit, 1.0, E_f / torch.clamp_min(E, _TINY))
    C_f = torch.where(unit, C, C * r_c)
    w_f = torch.where(unit, w_pow,
                      E_f / torch.clamp_min(T + stretch, _TINY))
    return {"T": T_f, "E": E_f, "C": C_f, "rt": r_t, "rc": r_c, "w": w_f}


def tier_tables(arrs: dict, tiers: tuple) -> dict:
    """Per-tier ground-truth tables [P, F, S] f32 from the engine's
    workload tensors: absolute ``T``/``E``/``C``/``w`` plus the ratios
    ``rt``/``rc`` that scale learned rows and predictions at selection."""
    dev = arrs["T_true"].device
    phi = torch.tensor(tiers, dtype=torch.float32, device=dev)[None, :, None]
    one = lambda x: x[:, None, :]
    n_idle = one(arrs["n_req"] * arrs["idle_w"][None, :])
    return _tier_model(one(arrs["T_true"]), one(arrs["E_true"]),
                       one(arrs["C_true"]), one(arrs["w_pow"]),
                       one(arrs["T_comp"]), one(arrs["E_comp"]), n_idle, phi)


def tier_tables_py(w, tiers: tuple) -> dict:
    """float64 numpy twin of ``tier_tables`` for the differential mirror
    (``core.simulator.simulate_py``), from a ``Workload`` of host arrays:
    the same [P, F, S] tables, with no fused rounding."""
    phi = np.asarray(tiers, np.float64)[None, :, None]
    Tc, Ec = phase_split(w)
    idle = (np.zeros(len(w.n_nodes)) if w.idle_w is None
            else np.asarray(w.idle_w, np.float64))
    T = np.asarray(w.T_true, np.float64)
    E = np.asarray(w.E_true, np.float64)
    one = lambda x: np.asarray(x, np.float64)[:, None, :]  # noqa: E731
    T, E, C = one(T), one(E), one(w.C_true)
    Tc, Ec = one(Tc), one(Ec)
    n_idle = one(np.asarray(w.n_req, np.float64) * idle[None, :])
    w_pow = E / np.maximum(T, _TINY)
    unit = phi == 1.0
    stretch = Tc * (1.0 / phi - 1.0)
    T_f = np.where(unit, T, T + stretch)
    E_f = np.where(unit, E, E + Ec * (phi ** 2 - 1.0) + n_idle * stretch)
    r_t = np.where(unit, 1.0, T_f / np.maximum(T, _TINY))
    r_c = np.where(unit, 1.0, E_f / np.maximum(E, _TINY))
    return {"T": T_f, "E": E_f, "C": np.where(unit, C, C * r_c),
            "rt": r_t, "rc": r_c,
            "w": np.where(unit, w_pow, E_f / np.maximum(T_f, _TINY))}


def npb_phase_split(systems, programs, N) -> tuple:
    """Exact ``(T_comp, E_comp)`` [P, S] for an NPB workload: compute-phase
    seconds from ``predict_phases`` at the Table 6 node counts, dynamic
    compute joules ``n * cpu_w * t_comp``."""
    P, S = len(programs), len(systems)
    Tc = np.zeros((P, S))
    Ec = np.zeros((P, S))
    for pi, prog in enumerate(programs):
        for si, sys in enumerate(systems):
            n = int(N[pi, si])
            t_comp, _, _ = predict_phases(NPB_PROFILES[prog], sys, n)
            Tc[pi, si] = t_comp
            Ec[pi, si] = n * sys.cpu_w * t_comp
    return Tc, Ec


def pareto_mask(energy, makespan) -> np.ndarray:
    """Boolean mask of the non-dominated (energy, makespan) points
    (minimizing both); ties survive together."""
    e = np.asarray(energy, np.float64).ravel()
    m = np.asarray(makespan, np.float64).ravel()
    dom = ((e[None, :] <= e[:, None]) & (m[None, :] <= m[:, None])
           & ((e[None, :] < e[:, None]) | (m[None, :] < m[:, None])))
    return ~dom.any(axis=1)
