"""Port parity: the policy registry and the branchless selector
(repro_torch.core.policy) against the reference's ``select``.

Rows are random per lane, with exact C ties (C drawn from a small set),
unexplored systems (zero runs), negative K (no feasible system: the
all-infeasible fallback) and, for the DVFS entries, the (tier x system)
candidate axis.  The chosen index must be equal in every lane.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import policy as r_pol  # noqa: E402
from repro_torch.convert import policy_from_reference  # noqa: E402
from repro_torch.core import policy as t_pol  # noqa: E402
from repro_torch.utils import prng  # noqa: E402

FCFS_ENTRIES = tuple(n for n in r_pol.policy_names()
                     if r_pol.make_policy(n).queue == "fcfs")
B = 64


def _rows(n_cand, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    c = rng.choice([1.0e-3, 2.5e-3, 2.5e-3, 4.0e-3], (B, n_cand)).astype(f32)
    t = rng.choice([100.0, 120.0, 150.0, 400.0], (B, n_cand)).astype(f32)
    t += rng.integers(0, 2, (B, n_cand)).astype(f32)     # some exact T ties
    runs = rng.integers(0, 3, (B, n_cand)).astype(np.int32)
    runs[: B // 2] = np.maximum(runs[: B // 2], 1)     # half fully explored
    avail = rng.choice([0.0, 50.0, 75.0], (B, n_cand)).astype(f32)
    k = rng.choice([-0.5, 0.0, 0.05, 0.2, 1.0], B).astype(f32)
    c_pred = rng.uniform(1e-3, 5e-3, n_cand).astype(f32)
    t_pred = rng.uniform(90, 450, n_cand).astype(f32)
    return dict(c_row=c, t_row=t, runs_row=runs, avail_row=avail, k=k,
                c_pred_row=c_pred, t_pred_row=t_pred)


def test_registry_names_and_specs_match():
    assert r_pol.policy_names() == t_pol.policy_names()
    for name in r_pol.policy_names():
        r, t = r_pol.make_policy(name), t_pol.make_policy(name)
        assert policy_from_reference(r) == t
    spec = "ucb:k=0.1,ucb_scale=0.25,freq_tiers=1.0+0.8,window=16"
    assert policy_from_reference(r_pol.parse_policy_spec(spec)) == \
        t_pol.parse_policy_spec(spec)
    assert r_pol.parse_queue_spec("easy_backfill:window=4") == \
        t_pol.parse_queue_spec("easy_backfill:window=4")
    assert t_pol.apply_queue_spec(t_pol.make_policy("paper"),
                                  "easy_backfill:window=4").window == 4
    with pytest.raises(ValueError):
        t_pol.make_policy("nope")
    with pytest.raises(ValueError):
        t_pol.Policy(freq_tiers=(0.8, 1.0))


@pytest.mark.parametrize("name", FCFS_ENTRIES)
def test_select_matches_reference(name):
    params = {"ucb_scale": 0.35, "freq_weight": 2.0e-6}
    rp = r_pol.make_policy(name, **params)
    tp = t_pol.make_policy(name, **params)
    n_cand = 4 * len(rp.freq_tiers)
    for seed in range(3):
        rows = _rows(n_cand, seed)
        keys = jax.vmap(lambda j: jax.random.fold_in(
            jax.random.key(seed), j))(jnp.arange(B))
        ref = jax.jit(jax.vmap(lambda c, t, r, a, k, key: r_pol.select(
            rp, c_row=c, t_row=t, runs_row=r, avail_row=a, k=k,
            c_pred_row=jnp.asarray(rows["c_pred_row"]),
            t_pred_row=jnp.asarray(rows["t_pred_row"]), key=key)))(
            rows["c_row"], rows["t_row"], rows["runs_row"],
            rows["avail_row"], rows["k"], keys)
        draw = prng.randint(prng.fold_in(prng.key(seed), torch.arange(B)),
                            (), 0, n_cand)
        out = t_pol.select(tp, **{n: torch.from_numpy(v)
                                  for n, v in rows.items()}, draw=draw)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref),
                                      err_msg=f"seed {seed}")


def test_lex_argmin_ties_and_all_infeasible():
    c = torch.tensor([[2.0, 1.0, 1.0, 3.0], [2.0, 1.0, 1.0, 3.0]])
    t = torch.tensor([[5.0, 9.0, 7.0, 1.0], [5.0, 7.0, 7.0, 1.0]])
    # exact C tie broken on T, then on the first index
    assert t_pol._paper_rule(c, t, torch.tensor([10.0, 10.0])).tolist() \
        == [2, 1]
    # K < 0: nothing is feasible, so every system is considered
    assert t_pol._paper_rule(c, t, torch.tensor([-0.5, -0.5])).tolist() \
        == [2, 1]
