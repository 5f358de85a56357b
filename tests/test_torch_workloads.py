"""Port parity: the NPB-analogue workloads (repro_torch.workloads) against
the reference's (repro.workloads) on the CPU, from the same seeds.

Bands (PERF.md "Parity bands"):
  IS keys, ranks, total       exact (threefry bit-equal, integer counts)
  EP hist, accepted           exact (histogram exact at these sizes)
  EP sx, sy                   rtol 1e-5 (the reference sums each batch in
                              f32, the port in f64 rounded once; at most
                              2.2e-7 seen)
  CFD from the reference's u0 max|du| <= 1e-6 * max|u|, residuals rtol 5e-6
                              (XLA contracts the Thomas recurrences into
                              fused multiply-adds; at most 3.2e-7 seen)
  CFD end to end              max|du| <= 5e-6 * max|u|, residuals rtol 5e-6
                              (torch.erfinv against XLA's erf_inv in the
                              initial draw; at most 1.5e-6 seen)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

from repro.workloads import BENCHMARKS as J_BENCHMARKS  # noqa: E402
from repro.workloads import run_benchmark as j_run_benchmark  # noqa: E402
from repro.workloads import thomas_tridiag as j_thomas  # noqa: E402
from repro.workloads.cfd import run_cfd as j_run_cfd  # noqa: E402
from repro.workloads.ep import run_ep as j_run_ep  # noqa: E402
from repro.workloads.ep import verify_ep as j_verify_ep  # noqa: E402
from repro.workloads.is_sort import run_is as j_run_is  # noqa: E402
from repro.workloads.is_sort import verify_is as j_verify_is  # noqa: E402
from repro_torch.kernels.ep import ep_pass_cuda  # noqa: E402
from repro_torch.kernels.is_hist import key_histogram_cuda  # noqa: E402
from repro_torch.kernels.stencil3d import stencil7_cuda  # noqa: E402
from repro_torch.utils.fp import fma  # noqa: E402
from repro_torch.workloads import (BENCHMARKS, SCALES,  # noqa: E402
                                   cfd_iterate, run_benchmark, run_ep,
                                   run_is, thomas_tridiag, verify_ep,
                                   verify_is)
from repro_torch.workloads.cfd import cfd_flops  # noqa: E402
from repro_torch.workloads.ep import ep_flops  # noqa: E402
from repro_torch.workloads.is_sort import is_ops  # noqa: E402
from repro.workloads.cfd import cfd_flops as j_cfd_flops  # noqa: E402
from repro.workloads.ep import ep_flops as j_ep_flops  # noqa: E402
from repro.workloads.is_sort import is_ops as j_is_ops  # noqa: E402

CFD_ITER_BAND = 1e-6
CFD_FULL_BAND = 5e-6
RESIDUAL_RTOL = 5e-6


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _check_ep(res, ref):
    np.testing.assert_array_equal(_np(res["hist"]), np.asarray(ref["hist"]))
    assert float(res["accepted"]) == float(ref["accepted"])
    assert res["n_pairs"] == ref["n_pairs"]
    for k in ("sx", "sy"):
        np.testing.assert_allclose(_np(res[k]), np.asarray(ref[k]),
                                   rtol=1e-5)


def _check_is(res, ref):
    for k in ("keys", "ranks", "total_counted"):
        np.testing.assert_array_equal(_np(res[k]), np.asarray(ref[k]))
    assert res["keys"].dtype == torch.int32
    assert (res["n"], res["iterations"]) == (ref["n"], ref["iterations"])


def _check_cfd(res, ref, band):
    u, r = np.asarray(ref["u"]), np.asarray(ref["residuals"])
    assert res["u"].shape == u.shape and res["residuals"].shape == r.shape
    err = np.abs(_np(res["u"]).astype(np.float64) - u).max()
    assert err <= band * np.abs(u).max(), (err, np.abs(u).max())
    np.testing.assert_allclose(_np(res["residuals"]), r, rtol=RESIDUAL_RTOL)


def test_program_list_matches_reference():
    assert BENCHMARKS == J_BENCHMARKS


@pytest.mark.parametrize("name", BENCHMARKS)
def test_run_benchmark_smoke_matches_reference(name):
    res, ok, ops = run_benchmark(name, "smoke", device="cpu")
    ref, ref_ok, ref_ops = j_run_benchmark(name, "smoke")
    assert ok and ref_ok
    assert ops == ref_ops
    if name == "EP":
        _check_ep(res, ref)
    elif name == "IS":
        _check_is(res, ref)
    else:
        _check_cfd(res, ref, CFD_FULL_BAND)
    for v in res.values():
        if torch.is_tensor(v):
            assert v.device.type == "cpu"


@pytest.mark.parametrize("m,batch_pow,seed", [(16, 12, 0), (14, 14, 3),
                                              (12, 16, 1)])
def test_run_ep_matches_reference(m, batch_pow, seed):
    """``batch_pow`` changes the draws (one fold_in per batch) and the
    port follows it; a batch larger than 2^m is cut to 2^m."""
    res = run_ep(m=m, batch_pow=batch_pow, seed=seed, device="cpu")
    ref = j_run_ep(m=m, batch_pow=batch_pow, seed=seed)
    _check_ep(res, ref)
    assert verify_ep(res) == j_verify_ep(ref)


@pytest.mark.parametrize("draw_pairs,passes", [
    (2 ** 16, 1),                 # the whole run in one pass
    (2 ** 14, 4),                 # several passes of 4 batches
    (5 * 2 ** 12, 4),             # 5 + 5 + 5 + 1: a ragged last pass
])
def test_run_ep_draw_passes_match_reference(monkeypatch, draw_pairs, passes):
    """``run_ep`` adds one draw pass per ``ep_pass`` call into its carry;
    the grouping of batches into passes changes nothing: equal to the
    reference's per-batch scan (hist exact, sums rtol 1e-5) and bit-equal
    to the one-pass run."""
    import repro_torch.workloads.ep as port_ep
    one_pass = run_ep(m=16, batch_pow=12, seed=2, device="cpu")
    calls = []
    real = port_ep.ep_pass

    def counted(u, *a, **k):
        calls.append(u.shape[0])
        return real(u, *a, **k)

    monkeypatch.setattr(port_ep, "_DRAW_PAIRS", draw_pairs)
    monkeypatch.setattr(port_ep, "ep_pass", counted)
    res = run_ep(m=16, batch_pow=12, seed=2, device="cpu")
    assert len(calls) == passes and sum(calls) == 16
    _check_ep(res, j_run_ep(m=16, batch_pow=12, seed=2))
    for k in ("hist", "sx", "sy", "accepted"):
        assert torch.equal(res[k], one_pass[k]), k


@pytest.mark.parametrize("n_pow,bucket_pow,iterations,seed", [
    (12, 10, 3, 0), (14, 6, 2, 5), (10, 10, 1, 2)])
def test_run_is_matches_reference(n_pow, bucket_pow, iterations, seed):
    res = run_is(n_pow=n_pow, bucket_pow=bucket_pow, iterations=iterations,
                 seed=seed, device="cpu")
    ref = j_run_is(n_pow=n_pow, bucket_pow=bucket_pow,
                   iterations=iterations, seed=seed)
    _check_is(res, ref)
    assert verify_is(res) == j_verify_is(ref)


def test_verify_is_rejects_a_broken_ranking():
    res = run_is(n_pow=12, iterations=2, device="cpu")
    assert verify_is(res)
    bad = dict(res, ranks=-res["ranks"])
    assert not verify_is(bad)
    assert not verify_is(dict(res, total_counted=res["total_counted"] - 1))


@pytest.mark.parametrize("variant", ["BT", "SP", "LU"])
@pytest.mark.parametrize("nx,iters", [(16, 5), (24, 3)])
def test_cfd_iteration_from_reference_u0(variant, nx, iters):
    """The iteration alone, from the reference's own initial grid, within
    the tighter band (no erfinv difference in the input)."""
    ref = j_run_cfd(nx=nx, iters=iters, variant=variant)
    u0 = np.array(jax.random.normal(jax.random.key(0), (nx, nx, nx),
                                    jnp.float32))
    res = cfd_iterate(torch.from_numpy(u0), iters, variant)
    _check_cfd(res, ref, CFD_ITER_BAND)


def test_op_counts_match_reference():
    for m in (18, 22, 28):
        assert ep_flops(m) == j_ep_flops(m)
    for n_pow in (16, 20, 23):
        assert is_ops(n_pow) == j_is_ops(n_pow)
    for v in ("BT", "SP", "LU"):
        for nx, iters in ((24, 5), (64, 20)):
            assert cfd_flops(nx, iters, v) == j_cfd_flops(nx, iters, v)


def test_scales_keep_the_reference_sizes():
    assert SCALES["smoke"] == {"ep_m": 18, "is_pow": 16, "cfd_nx": 24,
                               "cfd_iters": 5}
    assert SCALES["small"] == {"ep_m": 22, "is_pow": 20, "cfd_nx": 64,
                               "cfd_iters": 20}
    with pytest.raises(ValueError, match="scale"):
        run_benchmark("EP", "huge", device="cpu")
    with pytest.raises(KeyError):
        run_benchmark("MG", "smoke", device="cpu")


def test_cpu_runs_launch_no_kernel():
    before = (ep_pass_cuda.launches, key_histogram_cuda.launches,
              stencil7_cuda.launches)
    for name in ("EP", "IS", "LU"):
        run_benchmark(name, "smoke", device="cpu")
    assert (ep_pass_cuda.launches, key_histogram_cuda.launches,
            stencil7_cuda.launches) == before


def _tridiag(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.3, 0.0, shape).astype(np.float32)
    b = rng.uniform(2.0, 3.0, shape).astype(np.float32)
    c = rng.uniform(-0.3, 0.0, shape).astype(np.float32)
    d = rng.standard_normal(shape).astype(np.float32)
    return a, b, c, d


@pytest.mark.parametrize("shape,seed", [((64,), 0), ((3, 32), 1),
                                        ((4, 8, 32), 2)])
def test_thomas_matches_reference(shape, seed):
    a, b, c, d = _tridiag(shape, seed)
    x = thomas_tridiag(*map(torch.from_numpy, (a, b, c, d))).numpy()
    ref = np.asarray(j_thomas(*map(jnp.asarray, (a, b, c, d))))
    np.testing.assert_allclose(x, ref, rtol=1e-6, atol=1e-7)
    # and it solves the system
    A = np.zeros(shape + (shape[-1],))
    n = shape[-1]
    idx = np.arange(n)
    A[..., idx, idx] = b
    A[..., idx[1:], idx[:-1]] = a[..., 1:]
    A[..., idx[:-1], idx[1:]] = c[..., :-1]
    np.testing.assert_allclose(np.einsum("...ij,...j->...i", A, x), d,
                               atol=1e-5)


def test_thomas_difference_is_fused_multiply_add():
    """The reference's compiled scan contracts ``b - a*cp``, ``d - a*dp``
    and ``dp - cp*x`` into fused multiply-adds; written with
    ``utils.fp.fma`` the same recurrence equals it bit for bit.  The port
    keeps plain ops (each fma costs ~15 launches on the card) and states
    the difference as its band."""
    a, b, c, d = map(torch.from_numpy, _tridiag((64, 32), 3))
    ref = np.asarray(j_thomas(*map(jnp.asarray, (a.numpy(), b.numpy(),
                                                 c.numpy(), d.numpy()))))
    A, B, C, D = (t.movedim(-1, 0) for t in (a, b, c, d))
    cp, dp = torch.empty_like(A), torch.empty_like(A)
    cpp = dpp = torch.zeros(A.shape[1:])
    for i in range(A.shape[0]):
        den = fma(-A[i], cpp, B[i])
        cpp, dpp = C[i] / den, fma(-A[i], dpp, D[i]) / den
        cp[i], dp[i] = cpp, dpp
    x, carry = torch.empty_like(A), torch.zeros_like(cpp)
    for i in range(A.shape[0] - 1, -1, -1):
        carry = fma(-cp[i], carry, dp[i])
        x[i] = carry
    np.testing.assert_array_equal(x.movedim(0, -1).numpy(), ref)
    plain = thomas_tridiag(a, b, c, d).numpy()
    assert not np.array_equal(plain, ref)


def test_thomas_batched_over_grid():
    shape = (4, 8, 32)
    ones = torch.ones(shape)
    x = thomas_tridiag(0 * ones, 2 * ones, 0 * ones, ones)
    np.testing.assert_allclose(x.numpy(), 0.5 * np.ones(shape), atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("name", BENCHMARKS)
def test_run_benchmark_on_card_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    res, ok, _ = run_benchmark(name, "smoke")
    plain, plain_ok, _ = run_benchmark(name, "smoke", force="torch")
    assert ok and plain_ok
    for k, v in res.items():
        if k in ("sx", "sy"):
            torch.testing.assert_close(v, plain[k], rtol=1e-6, atol=0.0)
        elif torch.is_tensor(v):
            assert torch.equal(v, plain[k]), k
