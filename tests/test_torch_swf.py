"""Port parity: the SWF trace front end of ``repro_torch.data.scenarios``
against the reference's ``repro.data.scenarios``.

Both packages parse the same files and columns; every array of every
built ``Workload`` must be equal (``np.array_equal``, dtypes included):
the constructors run the same host numpy arithmetic.
"""

import dataclasses
import gzip
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import JSCC_SYSTEMS as R_SYSTEMS  # noqa: E402
from repro.data import scenarios as rs  # noqa: E402
from repro_torch.core import JSCC_SYSTEMS as T_SYSTEMS  # noqa: E402
from repro_torch.data import scenarios as ts  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "jscc_sample.swf.gz")


def _assert_workloads_equal(r, t):
    for f in dataclasses.fields(r):
        a, b = getattr(r, f.name), getattr(t, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a is not None and b is not None, f.name
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
            assert np.array_equal(a, b, equal_nan=True), f.name
        else:
            assert a == b, f.name


def test_load_swf_fixture_matches_reference():
    r, t = rs.load_swf(FIXTURE), ts.load_swf(FIXTURE)
    assert len(t) == len(r) > 0
    assert [dataclasses.astuple(j) for j in t] == \
        [dataclasses.astuple(j) for j in r]
    assert t[0].submit == 0.0


def test_load_swf_comments_fallback_and_drops(tmp_path):
    """';' comments and blank lines skipped, allocated processors fall
    back to requested ones, jobs with no runtime or processors dropped,
    submits rebased to the first job; plain and gzipped files alike."""
    lines = ["; Version: 2.2", "",
             "1 100 0 50 4 0 0 4 0 0 1 1 1 1 1 1 -1 -1",
             "2 90 0 30 -1 0 0 8 0 0 1 1 1 1 1 1 -1 -1",
             "3 120 0 -1 4 0 0 4 0 0 1 1 1 1 1 1 -1 -1",
             "4 130 0 20 0 0 0 0 0 0 1 1 1 1 1 1 -1 -1",
             "5 140 0 10"]
    plain = tmp_path / "t.swf"
    plain.write_text("\n".join(lines))
    packed = tmp_path / "t.swf.gz"
    with gzip.open(packed, "wt") as f:
        f.write("\n".join(lines))
    for src in (plain, str(packed), lines):
        r, t = rs.load_swf(src), ts.load_swf(src)
        assert [dataclasses.astuple(j) for j in t] == \
            [dataclasses.astuple(j) for j in r] == \
            [(2, 0.0, 30.0, 8), (1, 10.0, 50.0, 4)]


@pytest.mark.parametrize("n,seed", [(500, 11), (64, 3)])
def test_synthetic_swf_and_round_trip(n, seed):
    """``synthetic_swf_arrays`` draws the same columns; ``swf_lines``
    writes the same records, and loading them back gives the columns."""
    r_cols = rs.synthetic_swf_arrays(n, seed=seed)
    t_cols = ts.synthetic_swf_arrays(n, seed=seed)
    for a, b in zip(r_cols, t_cols):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    lines = ts.swf_lines(*t_cols)
    assert lines == rs.swf_lines(*r_cols)
    jobs = ts.load_swf(lines)
    submit, runtime, procs = t_cols
    order = np.argsort(submit, kind="stable")
    assert [j.runtime for j in jobs] == runtime[order].astype(float).tolist()
    assert [j.procs for j in jobs] == procs[order].tolist()
    np.testing.assert_array_equal([j.submit for j in jobs],
                                  (submit[order] - submit.min()))


@pytest.mark.parametrize("calibrate", [False, True])
@pytest.mark.parametrize("bins", [(4, 4), (2, 3)])
def test_workload_from_arrays_matches(calibrate, bins):
    cols = rs.synthetic_swf_arrays(400, seed=5)
    kw = dict(n_size_bins=bins[0], n_time_bins=bins[1], calibrate=calibrate)
    r = rs.workload_from_arrays(*cols, R_SYSTEMS, **kw)
    t = ts.workload_from_arrays(*cols, T_SYSTEMS, **kw)
    _assert_workloads_equal(r, t)
    assert (t.T_comp is not None) == calibrate


@pytest.mark.parametrize("calibrate", [False, True])
def test_workload_from_trace_and_swf_match(calibrate):
    """The fixture built in each package from the same file."""
    r = rs.workload_from_trace(rs.load_swf(FIXTURE), R_SYSTEMS,
                               calibrate=calibrate)
    t = ts.workload_from_trace(ts.load_swf(FIXTURE), T_SYSTEMS,
                               calibrate=calibrate)
    _assert_workloads_equal(r, t)
    r = rs.workload_from_swf(FIXTURE, R_SYSTEMS, calibrate=calibrate)
    t = ts.workload_from_swf(FIXTURE, T_SYSTEMS, calibrate=calibrate)
    _assert_workloads_equal(r, t)


def test_trace_workload_converts_field_for_field():
    """A trace-built reference workload, optional phase split included,
    carried across by ``convert.workload_from_reference``, equals the
    port's own build of the same file."""
    from repro_torch.convert import workload_from_reference
    r = rs.workload_from_swf(FIXTURE, R_SYSTEMS)
    assert r.T_comp is not None and r.E_comp is not None
    _assert_workloads_equal(workload_from_reference(r),
                            ts.workload_from_swf(FIXTURE, T_SYSTEMS))


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="empty trace"):
        ts.workload_from_trace([], T_SYSTEMS)
    with pytest.raises(ValueError, match="empty trace"):
        ts.workload_from_arrays([], [], [], T_SYSTEMS)
    with pytest.raises(ValueError, match="sum to 1"):
        ts.workload_from_arrays([0, 1], [10, 20], [4, 8], T_SYSTEMS,
                                calibrate=True,
                                phase_fractions=(0.5, 0.2, 0.1))
