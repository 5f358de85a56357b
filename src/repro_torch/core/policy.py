"""Composable scheduling policies: the registry and the branchless
selector, over a leading grid-lane dimension.

The policy family is factored along four axes (see the reference's
``repro/core/policy.py`` for the full description):

  exploration  first_released | predictive_fill | optimistic_bound
  feasibility  bare | queue_aware | none
  objective    min_c | min_t | min_avail | random | oracle
  queue        fcfs | easy_backfill | conservative

A ``Policy`` is a frozen dataclass.  The axis names, ``window`` and
``freq_tiers`` are static metadata that pick code paths; ``k``,
``ucb_scale``, ``power_cap`` and ``freq_weight`` are leaves that may carry
a leading grid axis, so one engine run covers a whole hyperparameter grid.

``select`` takes ``[B, S]`` rows, one per grid lane, and returns ``[B]``
chosen candidates.  It is written with ``where`` and masked reductions
only: no branch depends on tensor values, so it never synchronises with
the device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.utils.fp import fma

BIG = 1e30

EXPLORATIONS = ("first_released", "predictive_fill", "optimistic_bound")
FEASIBILITIES = ("bare", "queue_aware", "none")
OBJECTIVES = ("min_c", "min_t", "min_avail", "random", "oracle")
QUEUES = ("fcfs", "easy_backfill", "conservative")

#: power_cap values at or above this are "uncapped".
UNCAPPED = 1e29


def _host(x) -> np.ndarray:
    """A leaf as a host array (leaves may be floats, numpy or tensors)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass(frozen=True)
class Policy:
    """One point (or a leaf-batched grid) of the policy family."""
    exploration: str = "first_released"
    feasibility: str = "bare"
    objective: str = "min_c"
    name: str = ""
    k: object = 0.0                  # allowed runtime-increase fraction
    ucb_scale: object = 0.5          # optimism scale for unexplored C
    queue: str = "fcfs"              # queue discipline (engine axis)
    window: int = 8                  # pending-window bound (static)
    power_cap: object = float("inf")     # SCC cap in Watts (leaf)
    freq_tiers: tuple = (1.0,)       # DVFS multipliers (static; tier 0 = 1)
    freq_weight: object = 0.0        # energy<->time weight across tiers

    def __post_init__(self):
        if self.exploration not in EXPLORATIONS:
            raise ValueError(f"exploration {self.exploration!r} not in "
                             f"{EXPLORATIONS}")
        if self.feasibility not in FEASIBILITIES:
            raise ValueError(f"feasibility {self.feasibility!r} not in "
                             f"{FEASIBILITIES}")
        if self.objective not in OBJECTIVES:
            raise ValueError(f"objective {self.objective!r} not in "
                             f"{OBJECTIVES}")
        if self.queue not in QUEUES:
            raise ValueError(f"queue {self.queue!r} not in {QUEUES}")
        object.__setattr__(self, "window", int(self.window))
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        tiers = tuple(float(p) for p in np.atleast_1d(
            np.asarray(self.freq_tiers, dtype=np.float64)))
        object.__setattr__(self, "freq_tiers", tiers)
        if not tiers:
            raise ValueError("freq_tiers must be non-empty")
        if tiers[0] != 1.0:
            raise ValueError(f"freq_tiers[0] must be 1.0 (the uncapped "
                             f"anchor tier), got {tiers}")
        if any(not (0.0 < p <= 1.0) for p in tiers):
            raise ValueError(f"every freq tier must be in (0, 1], got "
                             f"{tiers}")

    @property
    def tiered(self) -> bool:
        """True when the DVFS tier axis is non-trivial."""
        return self.freq_tiers != (1.0,)

    @property
    def capped(self) -> bool:
        """True when any grid point carries a finite power cap."""
        return bool((_host(self.power_cap) < UNCAPPED).any())


# ---------------------------------------------------------------- registry

_REGISTRY: dict[str, object] = {}

#: The paper's nine historical selector modes, in their historical order.
LEGACY_MODES = ("paper", "queue_aware", "predictive", "ucb", "fastest",
                "greenest", "first_free", "random", "oracle")


def register_policy(name: str):
    """Decorator: register a Policy factory under ``name``."""
    def deco(factory):
        if name in _REGISTRY:
            raise ValueError(f"policy {name!r} already registered")
        _REGISTRY[name] = factory
        return factory
    return deco


def policy_names() -> tuple[str, ...]:
    """All registered policy names (legacy modes first, then extensions)."""
    extra = tuple(n for n in _REGISTRY if n not in LEGACY_MODES)
    return LEGACY_MODES + extra


def make_policy(name: str, **params) -> Policy:
    """Instantiate a registered policy, overriding hyperparameters."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; registered: "
                         f"{policy_names()}") from None
    return factory(**params)


def parse_policy_spec(spec: str, **defaults) -> Policy:
    """Parse a CLI policy spec ``name`` or ``name:key=val,key=val``
    (``queue`` as a name, ``window`` as an int, ``freq_tiers`` as
    ``a+b+c``, everything else as a float)."""
    name, _, rest = spec.partition(":")
    params = {}
    if rest:
        for item in rest.split(","):
            key, eq, val = item.partition("=")
            if not eq or not key:
                raise ValueError(f"bad policy param {item!r} in {spec!r} "
                                 "(expected key=val)")
            key = key.strip()
            if key == "queue":
                params[key] = val.strip()
            elif key == "window":
                params[key] = int(val)
            elif key == "freq_tiers":
                params[key] = tuple(float(p) for p in val.split("+"))
            else:
                params[key] = float(val)
    return make_policy(name.strip(), **{**defaults, **params})


def parse_queue_spec(spec: str) -> tuple:
    """Parse ``fcfs`` | ``easy_backfill[:window=W]`` into
    ``(discipline, window-or-None)``."""
    name, _, rest = spec.partition(":")
    name = name.strip()
    if name not in QUEUES:
        raise ValueError(f"unknown queue discipline {name!r}; known: "
                         f"{QUEUES}")
    window = None
    if rest:
        key, eq, val = rest.partition("=")
        if key.strip() != "window" or not eq:
            raise ValueError(f"bad queue param {rest!r} in {spec!r} "
                             "(expected window=W)")
        window = int(val)
    return name, window


def apply_queue_spec(policy: Policy, spec: str) -> Policy:
    """``policy`` with its queue discipline overridden by a queue spec."""
    name, window = parse_queue_spec(spec)
    over = {"queue": name}
    if window is not None:
        over["window"] = window
    return dataclasses.replace(policy, **over)


def _entry(name, exploration="first_released", feasibility="bare",
           objective="min_c", queue="fcfs", window=8, freq_tiers=(1.0,)):
    @register_policy(name)
    def factory(**params):
        base = dict(exploration=exploration, feasibility=feasibility,
                    objective=objective, name=name, queue=queue,
                    window=window, freq_tiers=freq_tiers)
        base.update(params)
        return Policy(**base)
    return factory


_entry("paper")
_entry("queue_aware", feasibility="queue_aware")
_entry("predictive", exploration="predictive_fill")
_entry("ucb", exploration="optimistic_bound")
_entry("fastest", objective="min_t")
_entry("greenest", feasibility="none")
_entry("first_free", objective="min_avail")
_entry("random", objective="random")
_entry("oracle", objective="oracle")
_entry("fastest_completion", feasibility="queue_aware", objective="min_t")
_entry("predictive_queue_aware", exploration="predictive_fill",
       feasibility="queue_aware")
_entry("easy_backfill", queue="easy_backfill")
_entry("easy_queue_aware", feasibility="queue_aware", queue="easy_backfill")
_entry("conservative", queue="conservative")
_entry("dvfs_paper", freq_tiers=(1.0, 0.8, 0.6))
_entry("dvfs_queue_aware", feasibility="queue_aware",
       freq_tiers=(1.0, 0.8, 0.6))


# ---------------------------------------------------------------- selector

def _lane(x, like):
    """A per-lane leaf ([B] or scalar) as a [B, 1] / [1] column."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x.unsqueeze(-1) if x.dim() else x.reshape(1)


def _lex_argmin(c_row, t_row, feasible):
    """Masked lexicographic argmin per lane: smallest C over ``feasible``,
    exact-tie break on T, first index on a full tie.  A lane with no
    feasible candidate considers all of them."""
    feasible = feasible | ~feasible.any(-1, keepdim=True)
    cbest = torch.where(feasible, c_row, BIG).amin(-1, keepdim=True)
    tie = feasible & (c_row == cbest)
    return torch.argmin(torch.where(tie, t_row, BIG), dim=-1)


def _paper_rule(c_row, t_row, k):
    """The paper's step 4 per lane: argmin C s.t. T <= T_min * (1 + K),
    tie-break on T.  ``k``: [B] or scalar."""
    onepk = 1.0 + _lane(k, t_row)
    feasible = t_row <= t_row.amin(-1, keepdim=True) * onepk
    return _lex_argmin(c_row, t_row, feasible)


def select(policy: Policy, *, c_row, t_row, runs_row, avail_row, k,
           c_pred_row=None, t_pred_row=None, draw=None):
    """Composed branchless selector over grid lanes: returns the chosen
    candidate index per lane, [B] int64.

    c_row/t_row: learned tables for this job's program [B, S]; runs_row:
    run counts [B, S]; avail_row: earliest start per candidate [B, S]; k:
    effective K per lane ([B] or scalar); *_pred_row: phase-model
    predictions ([S] or [B, S]; the TRUE tables for ``oracle``); draw: the
    ``random`` objective's pick per lane [B], drawn by the caller with
    ``utils.prng.randint(fold_in(sel_key, j), (), 0, S)``.
    """
    obj = policy.objective
    if obj == "min_avail":
        return torch.argmin(avail_row, dim=-1)
    if obj == "random":
        return draw.to(torch.int64)
    if obj == "oracle":
        c_pred_row, t_pred_row = torch.broadcast_tensors(
            c_pred_row, t_pred_row, c_row)[:2]
        return _paper_rule(c_pred_row, t_pred_row, k)

    known = runs_row > 0

    expl = policy.exploration
    if expl == "first_released":
        c_eff = torch.where(known, c_row, BIG)
        t_eff = torch.where(known, t_row, BIG)
    elif expl == "predictive_fill":
        c_eff = torch.where(known, c_row, c_pred_row)
        t_eff = torch.where(known, t_row, t_pred_row)
    else:  # optimistic_bound
        c_floor = (torch.where(known, c_row, BIG).amin(-1, keepdim=True)
                   * _lane(policy.ucb_scale, c_row))
        c_eff = torch.where(known, c_row, c_floor)
        t_eff = torch.where(known, t_row, torch.where(
            known, t_row, BIG).amin(-1, keepdim=True))

    feas = policy.feasibility
    if feas == "queue_aware":
        wait = avail_row - avail_row.amin(-1, keepdim=True)
        t_sel = torch.where(t_eff < BIG, t_eff + wait, BIG)
    else:
        t_sel = t_eff

    if obj == "min_c" and policy.tiered:
        c_eff = fma(_lane(policy.freq_weight, c_row),
                    torch.where(t_sel < BIG, t_sel, 0.0), c_eff)

    if obj == "min_c":
        if feas == "none":
            exploit = _lex_argmin(c_eff, t_sel, torch.ones_like(known))
        else:
            exploit = _paper_rule(c_eff, t_sel, k)
    else:  # min_t
        exploit = torch.argmin(t_sel, dim=-1)

    if expl == "first_released":
        explore = torch.argmin(torch.where(~known, avail_row, BIG), dim=-1)
        return torch.where((~known).any(-1), explore, exploit)
    return exploit
