"""(K, C) profile store: per-(program, system) history tables.

The paper's algorithm steps 2-3: look up C and T from previous runs; a
never-run (program, system) pair holds C = 0, T = 0 (the exploration
sentinel).  ``k_auto`` implements the paper's automatic K:  K = T_max / T
(ordered time over historical runtime), expressed here as the equivalent
allowed *increase fraction* max(0, T_max/T - 1).
"""

from __future__ import annotations

import numpy as np


class ProfileStore:
    """Dense history tables over |P| programs x |S| systems."""

    def __init__(self, n_programs: int, n_systems: int):
        self.C = np.zeros((n_programs, n_systems))
        self.T = np.zeros((n_programs, n_systems))
        self.runs = np.zeros((n_programs, n_systems), np.int64)

    def update(self, p: int, s: int, c: float, t: float):
        """Store the profile measured after a successful completion (paper:
        'After the successful completion ... the C and T values are stored').
        Running averages over repeat runs."""
        n = self.runs[p, s]
        self.C[p, s] = (self.C[p, s] * n + c) / (n + 1)
        self.T[p, s] = (self.T[p, s] * n + t) / (n + 1)
        self.runs[p, s] = n + 1

    def known(self, p: int) -> np.ndarray:
        return self.runs[p] > 0

    def fully_explored(self) -> bool:
        return bool((self.runs > 0).all())


def k_auto(t_max: float, t_hist: float) -> float:
    """Paper §Implementation: K = T_max / T when the program ran before and
    fit in its ordered time.  Returned as allowed-increase fraction."""
    if t_hist <= 0:
        return 0.0
    return max(0.0, t_max / t_hist - 1.0)
