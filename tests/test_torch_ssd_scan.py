"""Port parity: the SSD chunk-scan kernel's plain versions
(``repro_torch.kernels.ssd_scan``) against the reference's Pallas kernel
(interpret mode) and its oracle, at the shapes of ``tests/test_kernels.py``,
and the kernel's dispatch and wrapper checks.

On the CPU the port's dispatch runs the plain version; the CUDA kernel is
held against it on the card (the ``gpu`` tests below, and
``chip_smoke.py``'s ``kernel_ssd`` phase).  Band: the reference's own
kernel contract, atol 2e-4 (the two sides sum the same f32 products in
other orders).  The model-layout ``ssd_chunked`` is held to the
reference's at rtol 1e-5 / atol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_ref as j_ssd_scan_ref  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_chunked_dA, ssd_scan, ssd_scan_cuda, ssd_scan_ref)
from repro_torch.models import mamba  # noqa: E402

#: the reference's sweep (tests/test_kernels.py): bh, l, p, n, rep, chunk
SWEEP = [(4, 128, 16, 8, 2, 32), (2, 64, 8, 16, 1, 16),
         (6, 96, 32, 8, 3, 32)]
ATOL = 2e-4


def _inputs(bh, l, p, n, rep, seed, decay=None):
    """The reference test's distributions, drawn with numpy: x, B, C
    normal times 0.5, dt = softplus(normal), dA = dt * A with A =
    -exp(0.3 normal) per head (or the scalar ``decay``)."""
    rng = np.random.default_rng(seed)
    bg = bh // rep
    x = rng.standard_normal((bh, l, p)).astype(np.float32) * 0.5
    dt = np.logaddexp(rng.standard_normal((bh, l)), 0).astype(np.float32)
    A = (-np.exp(rng.standard_normal(bh) * 0.3) if decay is None
         else np.full(bh, decay)).astype(np.float32)
    dA = (dt * A[:, None]).astype(np.float32)
    B = rng.standard_normal((bg, l, n)).astype(np.float32) * 0.5
    C = rng.standard_normal((bg, l, n)).astype(np.float32) * 0.5
    return x, dt, dA, B, C


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("bh,l,p,n,rep,chunk", SWEEP)
def test_plain_matches_reference_kernel(bh, l, p, n, rep, chunk):
    arrs = _inputs(bh, l, p, n, rep, 0)
    y, s = ssd_scan(*_t(arrs), chunk=chunk)
    assert y.shape == (bh, l, p) and s.shape == (bh, p, n)
    assert y.dtype == s.dtype == torch.float32
    jy, js = ssd_scan_pallas(*map(jnp.asarray, arrs), chunk=chunk,
                             interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=ATOL)
    ry, rs = j_ssd_scan_ref(*map(jnp.asarray, arrs), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=ATOL)


def test_chunk_invariance():
    """The reference's case: chunk 16 against 64, and both against its
    kernel at chunk 16."""
    arrs = _inputs(2, 128, 8, 8, 1, 1, decay=-0.5)
    y16, s16 = ssd_scan(*_t(arrs), chunk=16)
    y64, s64 = ssd_scan(*_t(arrs), chunk=64)
    np.testing.assert_allclose(y16.numpy(), y64.numpy(), atol=ATOL)
    np.testing.assert_allclose(s16.numpy(), s64.numpy(), atol=ATOL)
    jy, js = ssd_scan_pallas(*map(jnp.asarray, arrs), chunk=16,
                             interpret=True)
    np.testing.assert_allclose(y64.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(s64.numpy(), np.asarray(js), atol=ATOL)


def test_chunk_is_clipped_to_the_length():
    arrs = _inputs(2, 64, 8, 8, 1, 2)
    y, s = ssd_scan(*_t(arrs), chunk=256)
    jy, js = ssd_scan_pallas(*map(jnp.asarray, arrs), chunk=256,
                             interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=ATOL)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_matches_reference(g):
    """The model-layout plain version (A per head, dA = dt * A inside)."""
    rng = np.random.default_rng(3)
    b, l, h, p, n, chunk = 2, 64, 4, 8, 16, 16
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, l, h)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    y, s = mamba.ssd_chunked(*_t((x, dt, A, B, C)), chunk)
    jy, js = jmamba.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


def test_model_layout_equals_flat_layout():
    """``ops.ssd_scan`` on model-layout tensors ([b, l, h, p], two groups)
    is the flat layout's scan of the same rows, bit for bit."""
    rng = np.random.default_rng(4)
    b, l, h, g, p, n = 2, 64, 4, 2, 8, 16
    x = torch.from_numpy(rng.standard_normal((b, l, h, p)).astype(np.float32))
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal((b, l, h)),
                                       0).astype(np.float32))
    dA = dt * -0.7
    B, C = (torch.from_numpy(rng.standard_normal((b, l, g, n)).astype(
        np.float32)) for _ in range(2))
    y, s = ssd_scan(x, dt, dA, B, C, chunk=16)
    assert y.shape == (b, l, h, p) and s.shape == (b, h, p, n)

    def flat(t):          # [b, l, k, ...] -> [b * k, l, ...]
        return t.transpose(1, 2).reshape(-1, l, *t.shape[3:])
    fy, fs = ssd_scan_ref(flat(x), flat(dt), flat(dA), flat(B), flat(C),
                          chunk=16)
    assert torch.equal(fy, flat(y)) and torch.equal(fs, s.reshape(-1, p, n))
    assert torch.equal(y, ssd_chunked_dA(x, dt, dA, B, C, 16)[0])


def test_dispatch_and_wrapper_refusals():
    x, dt, dA, B, C = _t(_inputs(2, 64, 8, 8, 1, 5))
    assert torch.equal(ssd_scan(x, dt, dA, B, C, chunk=16)[0],
                       ssd_scan(x, dt, dA, B, C, chunk=16, force="torch")[0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan(x, dt, dA, B, C, chunk=16, force="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan_cuda(x, dt, dA, B, C, chunk=16)
    for mode in ("pallas", "pallas_interpret", "jnp"):
        with pytest.raises(ValueError, match="modes"):
            ssd_scan(x, dt, dA, B, C, chunk=16, force=mode)
    assert _build.SOURCES["ssd_scan"].exists()
    assert _build.SOURCES["ssd_scan"].suffix == ".cu"


def test_plain_version_handles_a_long_decay_without_nan():
    """exp(cum_i - cum_j) overflows for j > i; the masked pairs must give
    0, not NaN (the reference's ``where``)."""
    arrs = list(_inputs(2, 256, 8, 8, 1, 6, decay=-3.0))
    y, s = ssd_scan(*_t(arrs), chunk=256)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    jy, _ = ssd_scan_pallas(*map(jnp.asarray, arrs), chunk=256,
                            interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)


# --------------------------------------------------------- card (skip here)

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,l,p,n,rep,chunk", SWEEP)
def test_kernel_matches_plain_on_card(bh, l, p, n, rep, chunk, dtype):
    dev = _card()
    x, dt, dA, B, C = _t(_inputs(bh, l, p, n, rep, 7))
    x, B, C = (t.to(dev, getattr(torch, dtype)) for t in (x, B, C))
    dt, dA = dt.to(dev), dA.to(dev)
    y, s = ssd_scan_cuda(x, dt, dA, B, C, chunk=chunk)
    torch.cuda.synchronize()
    ry, rs = ssd_scan_ref(x, dt, dA, B, C, chunk=chunk)
    torch.testing.assert_close(y, ry, atol=ATOL, rtol=0)
    torch.testing.assert_close(s, rs, atol=ATOL, rtol=0)


@pytest.mark.gpu
def test_kernel_reads_model_layout_views_on_card():
    """x, B, C as views of one conv output [b, l, d_inner + 2 g n]."""
    dev = _card()
    rng = np.random.default_rng(8)
    b, l, h, g, p, n = 2, 128, 4, 2, 16, 8
    xbc = torch.from_numpy(rng.standard_normal(
        (b, l, h * p + 2 * g * n)).astype(np.float32)).to(dev)
    x = xbc[..., :h * p].reshape(b, l, h, p)
    B = xbc[..., h * p:h * p + g * n].reshape(b, l, g, n)
    C = xbc[..., h * p + g * n:].reshape(b, l, g, n)
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal((b, l, h)),
                                       0).astype(np.float32)).to(dev)
    y, s = ssd_scan(x, dt, dt * -0.5, B, C, chunk=32)
    torch.cuda.synchronize()
    ry, rs = ssd_chunked_dA(x, dt, dt * -0.5, B, C, 32)
    torch.testing.assert_close(y, ry, atol=ATOL, rtol=0)
    torch.testing.assert_close(s, rs, atol=ATOL, rtol=0)
