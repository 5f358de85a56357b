"""The frozen generator against the port's scenario library: a mix with
the documented parameters gives the documented stream."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import generator

torch = pytest.importorskip("torch")
from repro_torch.data import scenarios as sc  # noqa: E402

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def _mix(name, jobs):
    return {**json.loads((TRAFFIC / f"{name}.json").read_text()),
            "jobs": jobs}


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_npb_stream_is_the_scenario_librarys(seed):
    got = generator.generate(_mix("npb-poisson", 600), seed)
    s = generator.stream_seed(seed)
    assert got["order"] == sc.sample_programs(600, None, s)
    np.testing.assert_array_equal(got["arrival"],
                                  sc.poisson_arrivals(600, 0.5, s))
    assert got["arrival"].dtype == np.float32


@pytest.mark.parametrize("seed", [0, 11, 2 ** 31 + 5])
def test_swf_stream_is_the_scenario_librarys(seed):
    got = generator.generate(_mix("swf-contended", 600), seed)
    s = generator.stream_seed(seed)
    cols = sc.synthetic_swf_arrays(600, s)
    assert got["lines"] == sc.swf_lines(*cols)
    jobs = sc.load_swf(got["lines"])
    assert len(jobs) == 600


def test_documented_mix_parameters():
    npb = _mix("npb-poisson", 10)
    assert [tuple(c) for c, _ in npb["mix"]] == [sc.NPB_SMALL, sc.NPB_LARGE]
    assert npb["rate"] == 0.5 and npb["arrival"] == "poisson"
    assert _mix("npb-poisson", 10000)["jobs"] == 10000


def test_negative_and_huge_seeds_draw():
    for seed in (-3, 2 ** 40 + 1):
        assert len(generator.generate(_mix("npb-poisson", 5), seed)
                   ["order"]) == 5


def test_unknown_kind_raises():
    with pytest.raises(ValueError):
        generator.generate({"kind": "nope", "jobs": 3}, 0)
