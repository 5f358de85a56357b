"""Port parity: the SSD chunk-scan kernel's plain versions
(``repro_torch.kernels.ssd_scan``) against the reference's Pallas kernel
(interpret mode) and its oracle, at the shapes of ``tests/test_kernels.py``,
and the kernel's dispatch and wrapper checks.

On the CPU the port's dispatch runs the plain version; the CUDA kernel is
held against it on the card (the ``gpu`` tests below, and
``chip_smoke.py``'s ``kernel_ssd`` phase).  The tensor-core route's
arithmetic (bf16 products with f32 sums, each derived f32 operand --
L o CB, the state entering a chunk, B w -- split into hi = bf16(a) and
lo = bf16(a - hi)) is emulated in plain torch here and held to the same
bands.  Band: the reference's own
kernel contract, atol 2e-4 (the two sides sum the same f32 products in
other orders).  The model-layout ``ssd_chunked`` is held to the
reference's at rtol 1e-5 / atol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

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


def _halves(a, split):
    hi = a.bfloat16().float()
    return (hi, (a - hi).bfloat16().float()) if split else (hi,)


def _ssd_split(x, dt, dA, B, C, chunk, split=True):
    """Plain-torch emulation of the tensor-core route on the flat layout:
    C.B once per group row and chunk, then per head row and chunk
    y_diag = (L o CB dt) x, y_off = exp(cum_i) C_i . prev^T and the own
    state x^T (B w), each a sum of bf16 products in f32 with the derived
    operand split in two (without ``split``, rounded once to bf16)."""
    bh, l, p = x.shape
    bg, _, n = B.shape
    rep = bh // bg
    xf, Bf, Cf = x.float(), B.float(), C.float()
    y = torch.zeros(bh, l, p)
    state = torch.zeros(bh, p, n)
    i = torch.arange(chunk)
    tri = i[:, None] >= i[None, :]
    for r in range(bh):
        prev = torch.zeros(p, n)
        for c0 in range(0, l, chunk):
            sl = slice(c0, c0 + chunk)
            xc, Bc, Cc, dtc = xf[r, sl], Bf[r // rep, sl], Cf[r // rep, sl], \
                dt[r, sl]
            cum = torch.cumsum(dA[r, sl], 0)
            L = torch.where(tri, torch.exp(torch.where(
                tri, cum[:, None] - cum[None, :], 0.0)), 0.0)
            M = (Cc @ Bc.T) * L * dtc[None, :]
            y[r, sl] = (sum(m @ xc for m in _halves(M, split))
                        + sum(Cc @ h.T for h in _halves(prev, split))
                        * torch.exp(cum)[:, None])
            w = torch.exp(cum[-1] - cum) * dtc
            own = sum(xc.T @ h for h in _halves(Bc * w[:, None], split))
            prev = prev * torch.exp(cum[-1]) + own
        state[r] = prev
    return y, state


def _bf16_inputs(arrs):
    """x, B, C rounded to bf16 (what the tensor-core route reads) as f32
    arrays, dt and dA as they are."""
    x, dt, dA, B, C = arrs
    rnd = [torch.from_numpy(a).bfloat16().float().numpy() for a in (x, B, C)]
    return rnd[0], dt, dA, rnd[1], rnd[2]


@pytest.mark.parametrize("bh,l,p,n,rep,chunk", SWEEP)
def test_split_operand_arithmetic_matches_reference(bh, l, p, n, rep, chunk):
    """bf16 inputs through the tensor-core route's arithmetic stay within
    the reference's atol 2e-4 of its oracle (2.5e-5 at most here)."""
    arrs = _bf16_inputs(_inputs(bh, l, p, n, rep, 9))
    y, s = _ssd_split(*_t(arrs), chunk)
    ry, rs = j_ssd_scan_ref(*map(jnp.asarray, arrs), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=ATOL)


@pytest.mark.parametrize("split", [True, False])
def test_derived_operands_need_the_split(split):
    """At the mamba2 path's magnitudes (silu'd x, B, C; one group of 8
    heads; l 1,024, p 64, n 128, chunk 256) the split uses under a tenth
    of the card's band, 2e-4 + 1e-4 max |ref|, against the reference's
    oracle; the derived operands rounded once to bf16 miss it more than
    ten times over, and miss atol 2e-4 at the reference's shapes too."""
    rng = np.random.default_rng(1)
    l, h, p, n = 1024, 8, 64, 128
    xbc = rng.standard_normal((l, h * p + 2 * n))
    xbc = (xbc / (1 + np.exp(-xbc))).astype(np.float32)
    x = np.ascontiguousarray(xbc[:, :h * p].reshape(l, h, p).transpose(1, 0, 2))
    B = np.ascontiguousarray(xbc[None, :, h * p:h * p + n])
    C = np.ascontiguousarray(xbc[None, :, h * p + n:])
    dt = np.logaddexp(rng.standard_normal((h, l)), 0).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    arrs = _bf16_inputs((x, dt, (dt * A[:, None]).astype(np.float32), B, C))
    y, s = _ssd_split(*_t(arrs), 256, split)
    ry, rs = map(np.asarray, j_ssd_scan_ref(*map(jnp.asarray, arrs),
                                            chunk=256))
    used = [np.abs(a - b).max() / (2e-4 + 1e-4 * np.abs(b).max())
            for a, b in ((y.numpy(), ry), (s.numpy(), rs))]
    if split:
        assert max(used) < 0.1
    else:
        assert min(used) > 10.0
        small = _bf16_inputs(_inputs(*SWEEP[0][:5], 9))
        sy, _ = _ssd_split(*_t(small), SWEEP[0][5], split)
        sry, _ = j_ssd_scan_ref(*map(jnp.asarray, small), chunk=SWEEP[0][5])
        assert np.abs(sy.numpy() - np.asarray(sry)).max() > ATOL


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,l,p,n,rep,chunk", SWEEP + [
    (2, 200, 20, 36, 2, 100), (3, 96, 72, 24, 3, 96)])
def test_routes_on_card(bh, l, p, n, rep, chunk, dtype):
    """bf16 x, B, C take the tensor-core launches and f32 the f32-core
    ones, both within atol 2e-4 of the plain version (shapes include
    rows that are not 16-byte aligned and ragged tiles)."""
    dev = _card()
    x, dt, dA, B, C = _t(_inputs(bh, l, p, n, rep, 11))
    x, B, C = (t.to(dev, getattr(torch, dtype)) for t in (x, B, C))
    dt, dA = dt.to(dev), dA.to(dev)
    y, s = ssd_scan_cuda(x, dt, dA, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.last_route == (
        "tensor-core" if dtype == "bfloat16" else "f32-core")
    ry, rs = ssd_scan_ref(x, dt, dA, B, C, chunk=chunk)
    torch.testing.assert_close(y, ry, atol=ATOL, rtol=0)
    torch.testing.assert_close(s, rs, atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_path_widths_on_card(dtype):
    """At the path's p 64, n 128 and chunk 256, |cum| grows over the
    chunk and the two summation orders of the cumsum move exp(cum_i -
    cum_j) by a few 1e-5 of itself: both routes within 2e-4 + 1e-4
    max |plain|, the band ``chip_smoke.py`` holds the path shape to."""
    dev = _card()
    x, dt, dA, B, C = _t(_inputs(4, 512, 64, 128, 4, 12))
    x, B, C = (t.to(dev, getattr(torch, dtype)) for t in (x, B, C))
    dt, dA = dt.to(dev), dA.to(dev)
    y, s = ssd_scan_cuda(x, dt, dA, B, C, chunk=256)
    torch.cuda.synchronize()
    ry, rs = ssd_scan_ref(x, dt, dA, B, C, chunk=256)
    for out, ref in ((y, ry), (s, rs)):
        band = ATOL + 1e-4 * float(ref.abs().max())
        assert float((out - ref).abs().max()) <= band
