"""The control: the reference put in the program's place and computed in
bfloat16, the precision below the configuration's float32, fails every
cell's comparison at the cell's limits (at a test's size; the card's runs
at the cells' own size are in PERF.md)."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import correct, generator, spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 9])
def test_bf16_control_is_not_correct(cell, seed):
    c = spec.cell(BENCH, ROOT, cell, False)
    jobs = 300
    traffic = generator.generate(c.traffic, seed)
    tab = correct.reference_tables(traffic, c.config, jobs)
    rng = np.random.default_rng(seed)
    pairs = [(int(g), int(s)) for g, s in zip(
        rng.integers(0, len(c.config["k_grid"]), 16),
        rng.integers(0, 2 ** 31, 16))]
    lanes = correct.lane_inputs(c.config, pairs)
    want = correct.reference_run(tab, c.config, lanes)
    got = correct.reference_run(tab, c.config, lanes, prec="bf16")
    numbers = {**correct.compare(got, want), "lanes_bad": 0}
    assert not correct.verdict(numbers, c.own["limits"])
    assert numbers["totals_rel_gap"] > 100 * c.own["limits"]["totals_rel_gap"]
    assert json.dumps(numbers)
