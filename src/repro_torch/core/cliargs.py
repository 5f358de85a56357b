"""The scheduler CLI's option grammar, as the reference defines it.

``launch/schedule.py`` parses its options here, so every spelling the
reference's CLI accepts parses to the same ``Policy`` in the port:

    --policy NAME[:key=val,...]   registered policy spec; values parse as
                                  floats, except ``window`` (int),
                                  ``queue`` (discipline name) and
                                  ``freq_tiers`` (a '+'-separated phi
                                  grid, e.g. ``freq_tiers=1.0+0.8+0.6``)
    --mode NAME / --k F           legacy spellings (--policy wins; --k
                                  fills in when the spec leaves k unset)
    --queue DISC[:window=W]       queue-discipline override:
                                  fcfs | easy_backfill | conservative
    --power-cap WATTS             SCC power cap (0 = uncapped); overrides
                                  the policy's ``power_cap`` leaf
    --engine {arrival,events}     scan granularity (``--core`` survives
                                  as a deprecated alias)
    --stragglers / --failures     fault-model probabilities
    --shards auto|N               device-shard the campaign grid axis
                                  (``add_scale_options``)
    --chunk SIZE                  stream the scan in SIZE-step windows

``build_policy`` / ``build_fault`` / ``build_engine`` / ``build_scale``
resolve parsed args into ``Scheduler`` arguments; ``policy_spec`` renders
a scalar policy back into the canonical ``--policy`` string.  A power
cap, ``--engine events`` and ``conservative`` run on the event-granular
core; ``--shards`` and ``--chunk``, not ported yet, parse as in the
reference and are refused by ``Scheduler`` with ``NotImplementedError``
naming their ROADMAP item.
"""

from __future__ import annotations

import warnings

import numpy as np

from repro_torch.core.engine import FaultConfig
from repro_torch.core.policy import (QUEUES, UNCAPPED, Policy,
                                     apply_queue_spec, make_policy,
                                     parse_policy_spec, policy_names)


def add_policy_options(ap, *, engine: bool = False, faults: bool = True):
    """Install the shared scheduler options on an argparse parser.

    ``engine=True`` adds the scan-granularity pair (``--engine`` plus the
    deprecated ``--core``); ``faults=True`` adds the fault-model
    probabilities.  Returns the parser for chaining.
    """
    ap.add_argument("--policy", default="", metavar="NAME[:key=val,...]",
                    help="registered policy spec, e.g. paper:k=0.1, "
                         "ucb:k=0.1,ucb_scale=0.25 or "
                         "dvfs_paper:freq_tiers=1.0+0.8+0.6,freq_weight=0.5"
                         f"; registry: {', '.join(policy_names())}")
    ap.add_argument("--mode", default="paper", choices=policy_names(),
                    help="legacy spelling of --policy NAME")
    ap.add_argument("--k", type=float, default=0.1,
                    help="legacy spelling of --policy NAME:k=F (fills in "
                         "when the spec does not set k)")
    ap.add_argument("--queue", default="", metavar="DISC[:window=W]",
                    help="queue discipline overriding the policy's own: "
                         f"{' | '.join(QUEUES)}; e.g. easy_backfill:window=16"
                         " or conservative:window=16")
    ap.add_argument("--power-cap", type=float, default=0.0, metavar="WATTS",
                    help="SCC power cap (0 = uncapped): placements are "
                         "deferred while cluster draw would exceed it "
                         "(event-granular core)")
    if engine:
        ap.add_argument("--engine", default="",
                        choices=("", "arrival", "events"),
                        help="scan granularity (default: auto — events for "
                             "conservative/power-capped runs)")
        ap.add_argument("--core", default="",
                        choices=("", "arrival", "events"),
                        help="DEPRECATED spelling of --engine")
    if faults:
        ap.add_argument("--stragglers", type=float, default=0.0,
                        help="per-job straggler probability")
        ap.add_argument("--failures", type=float, default=0.0,
                        help="per-job failure probability (enables retries)")
    return ap


def add_scale_options(ap):
    """Install the campaign scale-out pair (``--shards``/``--chunk``) —
    shared by the batch CLI and the million-job benches.  Returns the
    parser for chaining."""
    ap.add_argument("--shards", default="", metavar="auto|N",
                    help="shard the campaign grid across local devices "
                         "(shard_map): 'auto' = every device, N = explicit "
                         "count; default: single-device vmap")
    ap.add_argument("--chunk", type=int, default=0, metavar="SIZE",
                    help="stream the event scan in SIZE-step windows with "
                         "the carry threaded between chunks (bounded "
                         "memory for million-job traces; 0 = monolithic)")
    return ap


def build_scale(args) -> dict:
    """Resolve the scale-out pair into ``Scheduler(shards=, chunk=)``
    kwargs (absent flags resolve to the single-device monolithic
    defaults, so callers can always ``**build_scale(args)``)."""
    shards = getattr(args, "shards", "") or None
    if shards is not None and shards != "auto":
        try:
            shards = int(shards)
        except ValueError:
            raise ValueError(
                f"--shards expects 'auto' or a device count, got "
                f"{shards!r}") from None
    chunk = int(getattr(args, "chunk", 0) or 0) or None
    return {"shards": shards, "chunk": chunk}


def build_policy(args) -> Policy:
    """Resolve the parsed shared options into one ``Policy``: the spec
    (or the legacy ``--mode``/``--k`` pair), then the ``--queue``
    override, then the ``--power-cap`` override — the same precedence
    both CLIs historically applied."""
    if args.policy:
        pol = parse_policy_spec(args.policy, k=args.k)
    else:
        pol = make_policy(args.mode, k=args.k)
    if args.queue:
        pol = apply_queue_spec(pol, args.queue)
    if args.power_cap:
        from dataclasses import replace
        pol = replace(pol, power_cap=float(args.power_cap))
    return pol


def build_fault(args) -> FaultConfig | None:
    """The fault model the flags describe, or None when both are zero."""
    if args.failures or args.stragglers:
        return FaultConfig(straggler_prob=args.stragglers,
                           failure_prob=args.failures)
    return None


def build_engine(args) -> str | None:
    """Resolve ``--engine`` (with the deprecated ``--core`` alias) to the
    ``Scheduler(engine=...)`` value; conflicting values are an error."""
    core = getattr(args, "core", "")
    engine = getattr(args, "engine", "")
    if core:
        warnings.warn("--core is deprecated; use --engine",
                      DeprecationWarning, stacklevel=2)
        if engine and engine != core:
            raise ValueError(f"--core {core} conflicts with --engine "
                             f"{engine}")
        engine = engine or core
    return engine or None


def _fmt(x) -> str:
    f = float(np.asarray(x))
    if not np.isfinite(f):
        return "inf"
    return np.format_float_positional(f, trim="-")


def policy_spec(pol: Policy) -> str:
    """Render a scalar-leaf policy as the canonical ``--policy`` string
    (``parse_policy_spec(policy_spec(p)) == p``).  Grid-leaf policies have no CLI spelling and are rejected."""
    if not pol.name:
        raise ValueError("only registered (named) policies have a spec")
    for leaf in ("k", "ucb_scale", "power_cap", "freq_weight"):
        if np.asarray(getattr(pol, leaf)).ndim:
            raise ValueError(f"policy leaf {leaf!r} is a grid; specs "
                             "describe single points")
    parts = [f"k={_fmt(pol.k)}", f"ucb_scale={_fmt(pol.ucb_scale)}",
             f"queue={pol.queue}", f"window={int(pol.window)}"]
    cap = float(np.asarray(pol.power_cap))
    if cap < UNCAPPED:
        parts.append(f"power_cap={_fmt(cap)}")
    if pol.freq_tiers != (1.0,):
        parts.append("freq_tiers=" + "+".join(_fmt(t)
                                              for t in pol.freq_tiers))
        parts.append(f"freq_weight={_fmt(pol.freq_weight)}")
    return f"{pol.name}:{','.join(parts)}"
