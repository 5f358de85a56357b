"""Port parity: the scheduler CLI (``repro_torch.core.cliargs`` and
``repro_torch.launch.schedule``) against the reference's.

The option grammar resolves every spelling to the same ``Policy``, fault
model, engine and scale-out arguments (field for field), and ``main``
prints the reference's lines, character for character, on the paper
suite, EASY streams, the SWF fixture, the conservative, power-capped
and event-engine spellings (the ``peak_power`` line included) and with
``--shards`` / ``--chunk`` (``--device cpu``).  Options whose part is not
ported raise ``NotImplementedError`` naming their ROADMAP item.
"""

import argparse
import contextlib
import io
import os
import re
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.schedule as r_schedule  # noqa: E402
from repro.core import cliargs as r_cli  # noqa: E402
from repro_torch.convert import policy_from_reference  # noqa: E402
from repro_torch.core import cliargs as t_cli  # noqa: E402
from repro_torch.launch import schedule as t_schedule  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "jscc_sample.swf.gz")

#: the argv cases of tests/test_cliargs.py
ARGV = [
    ["--mode", "paper", "--k", "0.2"],
    ["--policy", "paper:k=0.1"],
    ["--policy", "paper", "--k", "0.3"],
    ["--policy", "ucb:k=0.1,ucb_scale=0.25"],
    ["--mode", "paper", "--queue", "easy_backfill:window=16"],
    ["--mode", "paper", "--queue", "conservative:window=4"],
    ["--mode", "paper", "--power-cap", "60000"],
    ["--policy", "dvfs_paper:freq_tiers=1.0+0.8+0.6,freq_weight=0.5"],
    ["--policy", "ucb:k=0.05", "--mode", "paper", "--queue",
     "easy_backfill:window=8", "--power-cap", "45000"],
    ["--failures", "0.1", "--stragglers", "0.05"],
    ["--engine", "events"],
    ["--engine", "arrival"],
    ["--shards", "auto"],
    ["--shards", "4", "--chunk", "65536"],
    ["--chunk", "0"],
]


def _parse(cli, argv):
    ap = argparse.ArgumentParser()
    cli.add_policy_options(ap, engine=True)
    cli.add_scale_options(ap)
    return ap.parse_args(argv)


@pytest.mark.parametrize("argv", ARGV, ids=" ".join)
def test_option_grammar_matches_reference(argv):
    ra, ta = _parse(r_cli, argv), _parse(t_cli, argv)
    assert vars(ra) == vars(ta)
    assert policy_from_reference(r_cli.build_policy(ra)) == \
        t_cli.build_policy(ta)
    assert t_cli.build_engine(ta) == r_cli.build_engine(ra)
    assert t_cli.build_scale(ta) == r_cli.build_scale(ra)
    rf, tf = r_cli.build_fault(ra), t_cli.build_fault(ta)
    assert (rf is None) == (tf is None)
    if rf is not None:
        assert (tf.straggler_prob, tf.failure_prob, tf.straggler_factor,
                tf.restart_overhead) == (rf.straggler_prob,
                                         rf.failure_prob,
                                         rf.straggler_factor,
                                         rf.restart_overhead)
    pol = t_cli.build_policy(ta)
    assert t_cli.policy_spec(pol) == r_cli.policy_spec(r_cli.build_policy(ra))


def test_grammar_errors_and_deprecation_match():
    with pytest.raises(ValueError, match="key=val"):
        t_cli.build_policy(_parse(t_cli, ["--policy", "paper:k"]))
    with pytest.raises(ValueError, match="queue"):
        t_cli.build_policy(_parse(t_cli, ["--queue", "nope"]))
    with pytest.raises(ValueError, match="--shards expects"):
        t_cli.build_scale(_parse(t_cli, ["--shards", "many"]))
    with pytest.warns(DeprecationWarning, match="--core is deprecated"):
        assert t_cli.build_engine(_parse(t_cli, ["--core", "events"])) \
            == "events"
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError, match="conflicts"):
            t_cli.build_engine(_parse(t_cli, ["--core", "arrival",
                                              "--engine", "events"]))
    with pytest.raises(ValueError, match="grid"):
        t_cli.policy_spec(t_cli.make_policy(
            "paper", k=np.asarray([0.1, 0.2], np.float32)))


def _reference_stdout(argv):
    out, old = io.StringIO(), sys.argv
    sys.argv = ["schedule"] + argv
    try:
        with contextlib.redirect_stdout(out):
            r_schedule.main()
    finally:
        sys.argv = old
    return out.getvalue()


def _port_stdout(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = t_schedule.main(argv + ["--device", "cpu"])
    return out.getvalue(), res


@pytest.mark.parametrize("argv", [
    [],                                                # the paper suite
    ["--jobs", "200", "--scenario", "diurnal",
     "--queue", "easy_backfill:window=16"],
    ["--trace", FIXTURE, "--queue", "easy_backfill:window=16",
     "--campaign-k", "0,0.1,0.3", "--campaign-seeds", "2"],
    ["--trace", FIXTURE, "--calibrate-trace", "--outage", "1:500:1500",
     "--queue", "easy_backfill", "--cold"],
    ["--sweep-k", "0,0.05,0.1,0.2"],
    ["--jobs", "300", "--scenario", "bursty", "--queue",
     "easy_backfill:window=8", "--campaign-k", "0,0.1",
     "--campaign-seeds", "2", "--totals-only", "--stragglers", "0.05",
     "--failures", "0.01"],
    ["--jobs", "200", "--scenario", "bursty", "--queue", "conservative",
     "--power-cap", "60000"],
    ["--jobs", "60", "--engine", "events", "--queue", "easy_backfill",
     "--failures", "0.1"],
    ["--jobs", "200", "--scenario", "diurnal", "--queue",
     "conservative:window=16"],
], ids=["paper", "easy_jobs", "trace_campaign", "trace_calibrated",
        "sweep_k", "easy_totals", "conservative_capped", "engine_events",
        "conservative_jobs"])
def test_main_prints_the_reference_lines(argv):
    ref = _reference_stdout(argv)
    out, res = _port_stdout(argv)
    assert out.splitlines() == ref.splitlines()
    assert res.total_energy.device.type == "cpu"


@pytest.mark.parametrize("argv,item", [
    (["--easy-eval", "unrolled", "--queue", "easy_backfill"], "item 15"),
    (["--shards", "auto"], "item 7"),
    (["--shards", "4", "--chunk", "65536"], "item 7"),
])
def test_unported_flags_raise_naming_their_item(argv, item):
    """Flags by ROADMAP item: item 15 is not ported and raises naming it;
    item 7 (campaign scale) is, so ``--shards`` / ``--chunk`` print the
    reference CLI's lines, or raise its ``ValueError`` where it does (4
    shards on one device)."""
    if item != "item 7":
        with pytest.raises(NotImplementedError, match=item):
            t_schedule.main(argv + ["--device", "cpu"])
        return
    try:
        ref = _reference_stdout(argv)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            _port_stdout(argv)
        return
    out, _ = _port_stdout(argv)
    assert out.splitlines() == ref.splitlines()


@pytest.mark.parametrize("argv", [
    ["--chunk", "1024"],
    ["--jobs", "120", "--scenario", "bursty", "--queue",
     "easy_backfill:window=8", "--campaign-k", "0,0.1",
     "--campaign-seeds", "2", "--totals-only", "--shards", "auto",
     "--chunk", "37"],
    ["--jobs", "60", "--engine", "events", "--failures", "0.1",
     "--chunk", "41"],
], ids=["chunk", "easy_campaign_sharded_chunked", "events_chunked"])
def test_scale_flags_print_the_reference_lines(argv):
    ref = _reference_stdout(argv)
    out, _ = _port_stdout(argv)
    assert out.splitlines() == ref.splitlines()


def test_default_device_is_cuda():
    """Without ``--device`` the CLI runs on the card and raises without
    one: it never drops to the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_schedule.main([])
