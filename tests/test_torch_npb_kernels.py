"""Port parity: the NPB kernels' plain torch versions
(repro_torch.kernels.{ep,is_hist,stencil3d}) against the reference's
Pallas kernels (interpret mode) and jnp oracles, at the shapes of
``tests/test_kernels.py``, and their dispatch.

On the CPU the port's dispatch runs the plain versions; the CUDA kernels
are held against them on the card (the ``gpu`` tests below, and
``chip_smoke.py``).  Bands: EP's histogram and IS's counts are exact;
EP's sums rtol 1e-5 (the reference sums in f32 in its own order, the
port sums in f64 and rounds once; at most 3.2e-7 seen here); the stencil
atol 2e-5 as the reference's own sweep (exact here, as XLA's CPU build
does not contract the stencil's products).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

from repro.kernels.ep import ep_pairs_pallas  # noqa: E402
from repro.kernels.ep import ep_pairs_ref as j_ep_ref  # noqa: E402
from repro.kernels.is_hist import key_histogram_pallas  # noqa: E402
from repro.kernels.is_hist import key_histogram_ref as j_is_ref  # noqa: E402
from repro.kernels.stencil3d import stencil7_pallas  # noqa: E402
from repro.kernels.stencil3d import stencil7_ref as j_st_ref  # noqa: E402
from repro_torch.kernels.ep import (ep_pairs, ep_pairs_cuda,  # noqa: E402
                                    ep_pairs_ref, ep_pass, ep_pass_cuda)
from repro_torch.kernels.is_hist import (SMEM_BUCKETS,  # noqa: E402
                                         key_histogram, key_histogram_cuda)
from repro_torch.kernels.stencil3d import stencil7, stencil7_cuda  # noqa: E402


def _pairs(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((2, n), dtype=np.float32) * 2 - 1).astype(np.float32)


def _edge_pairs(card=False):
    """Pairs with t == 0, t == 1 exactly, u = +-1, near-1 values and the
    smallest t a workload draw can give (its uniforms are multiples of
    2^-22, so t is 0 or >= 2^-44).  ``card`` adds two pairs on which the
    reference's CPU build is not a fixed yardstick: (0.6, 0.8), whose t is
    1.0 in separate ops but 1.0000001 where XLA contracts x*x + y*y into a
    fused multiply-add (it does in a vectorised loop, not for one pair),
    and a subnormal t, which XLA's CPU build flushes to 0 (rejecting the
    pair) while the port keeps it."""
    x = [0.0, 1.0, -1.0, 0.0, 1.0, -1.0, 0.5,
         np.nextafter(np.float32(1), np.float32(0)), 2.0 ** -22, -0.0]
    y = [0.0, 0.0, 0.0, -1.0, 1.0, -1.0, 0.5, 0.0, 0.0, -0.0]
    if card:
        x += [0.6, -0.6, 1e-20]
        y += [0.8, -0.8, 0.0]
    return np.array([x, y], np.float32)


def _keys(n, buckets, shift, seed, out_of_range=False):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, buckets << shift, n).astype(np.int32)
    if out_of_range:
        m = n // 8
        keys[:m] = rng.integers(-(buckets << shift), 0, m)          # negative
        keys[m:2 * m] = rng.integers(buckets << shift, 2 ** 31 - 1, m)
        keys[2 * m] = -2 ** 31
        keys[2 * m + 1] = 2 ** 31 - 1
    return keys


# ----------------------------------------------------------------------- EP

@pytest.mark.parametrize("n,block", [(4096, 1024), (8192, 2048), (2048, 2048)])
def test_ep_plain_matches_reference(n, block):
    u = _pairs(n, n)
    h1, s1 = ep_pairs_pallas(jnp.asarray(u), block_n=block, interpret=True)
    h2, s2 = j_ep_ref(jnp.asarray(u))
    h, s = ep_pairs(torch.from_numpy(u))
    assert h.dtype == s.dtype == torch.float32
    for hr, sr in ((h1, s1), (h2, s2)):
        np.testing.assert_array_equal(h.numpy(), np.asarray(hr))
        np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=1e-5)
    assert abs(float(h.sum()) / n - np.pi / 4) < 0.05


def test_ep_edge_pairs_match_reference():
    """t == 0 and t > 1 are rejected, t == 1 is accepted into annulus 0."""
    u = _edge_pairs()
    h, s = ep_pairs(torch.from_numpy(u))
    hr, sr = j_ep_ref(jnp.asarray(u))
    np.testing.assert_array_equal(h.numpy(), np.asarray(hr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    hp, _ = ep_pairs_pallas(jnp.asarray(u), block_n=u.shape[1],
                            interpret=True)
    np.testing.assert_array_equal(h.numpy(), np.asarray(hp))


def test_ep_overflowing_deviates_land_in_the_last_annulus():
    """Below t ~ 2.6e-37 the factor overflows: the deviates are +-inf (or
    NaN where 0 * inf), and the kernel and the plain version both count
    the pair in annulus 9 (the clip comes before the conversion, with
    NaN-ignoring max/min), so the two agree on every input."""
    u = torch.tensor([[1e-19, 1e-20, 0.5], [1e-19, 0.0, 0.5]])
    h, s = ep_pairs(u)
    assert h.tolist() == [1.0] + [0.0] * 8 + [2.0]
    assert s[0] == float("inf") and torch.isnan(s[1])


def _carry(counts_past_2_24):
    """A non-zero f32 carry; with ``counts_past_2_24`` its counts lie
    above 2^24, where adding a batch's odd count rounds."""
    base = 2.0 ** 24 + 2 if counts_past_2_24 else 7.0
    hist = torch.arange(10, dtype=torch.float32) * 1e5 + base
    return hist, torch.tensor([1234.5, -98765.25])


@pytest.mark.parametrize("nb,n,carry", [(4, 4096, "past_2_24"),
                                        (3, 1001, "small"), (5, 64, None),
                                        (1, 8192, "past_2_24")])
def test_ep_pass_equals_per_batch_loop(nb, n, carry):
    """The draw pass adds each batch into the f32 carry in batch order,
    bit-equal to the reference's scan body (``hist + h``, ``sx + s[0]``,
    ``sy + s[1]``) over per-batch ``ep_pairs_ref`` calls, with the
    rounding of counts past 2^24; its counts also equal the reference's
    kernel per batch carried in numpy f32."""
    u = np.stack([_pairs(n, 100 * nb + i) for i in range(nb)])
    if carry is None:
        hist, sums = torch.zeros(10), torch.zeros(2)
    else:
        hist, sums = _carry(carry == "past_2_24")
    sx, sy = sums[0].clone(), sums[1].clone()
    got = ep_pass(torch.from_numpy(u), hist.clone(), sums.clone())
    ref_hist = hist.numpy().copy()
    for ub in u:
        h, s = ep_pairs_ref(torch.from_numpy(ub))
        hist, sx, sy = hist + h, sx + s[0], sy + s[1]
        hp, _ = ep_pairs_pallas(jnp.asarray(ub), block_n=ub.shape[1],
                                interpret=True)
        ref_hist = ref_hist + np.asarray(hp)
    assert ref_hist.dtype == np.float32
    assert torch.equal(got[0], hist)
    assert torch.equal(got[1], torch.stack([sx, sy]))
    np.testing.assert_array_equal(got[0].numpy(), ref_hist)
    if carry == "past_2_24":                        # the adds did round
        exact = _carry(True)[0].double() + sum(
            ep_pairs_ref(torch.from_numpy(ub))[0].double() for ub in u)
        assert not torch.equal(got[0].double(), exact)


def test_ep_pass_updates_the_carries_in_place():
    u = torch.from_numpy(np.stack([_pairs(512, 1), _pairs(512, 2)]))
    hist, sums = _carry(False)
    h, s = ep_pass(u, hist, sums)
    assert h is hist and s is sums
    assert not torch.equal(hist, _carry(False)[0])


# ----------------------------------------------------------------------- IS

@pytest.mark.parametrize("n,buckets,shift,block", [
    (8192, 64, 8, 2048),
    (16384, 256, 6, 4096),
    (4096, 16, 10, 4096),
])
def test_is_plain_matches_reference(n, buckets, shift, block):
    keys = _keys(n, buckets, shift, shift)
    h1 = key_histogram_pallas(jnp.asarray(keys), n_buckets=buckets,
                              bucket_shift=shift, block_n=block,
                              interpret=True)
    h2 = j_is_ref(jnp.asarray(keys), n_buckets=buckets, bucket_shift=shift)
    h = key_histogram(torch.from_numpy(keys), n_buckets=buckets,
                      bucket_shift=shift)
    assert h.dtype == torch.float32
    np.testing.assert_array_equal(h.numpy(), np.asarray(h1))
    np.testing.assert_array_equal(h.numpy(), np.asarray(h2))
    assert int(h.sum()) == n


@pytest.mark.parametrize("buckets,shift", [(64, 8), (16, 10), (1024, 4)])
def test_is_out_of_range_keys_are_dropped(buckets, shift):
    """Negative and too-large buckets are dropped, as the Pallas kernel's
    one-hot drops them.  The reference's jnp oracle agrees on too-large
    buckets but wraps negative buckets in [-n_buckets, -1] to the end of
    the histogram (numpy indexing of ``.at[]``): the port follows the
    kernel, and the difference is exactly those wrapped counts."""
    n = 8192
    keys = _keys(n, buckets, shift, 5, out_of_range=True)
    keys[0:7] = -1                    # bucket -1: wrapped by the oracle
    keys[7:10] = -(2 << shift)        # bucket -2
    h = key_histogram(torch.from_numpy(keys), n_buckets=buckets,
                      bucket_shift=shift).numpy()
    pal = key_histogram_pallas(jnp.asarray(keys), n_buckets=buckets,
                               bucket_shift=shift, block_n=2048,
                               interpret=True)
    np.testing.assert_array_equal(h, np.asarray(pal))
    bucket = keys.astype(np.int64) >> shift
    in_range = (bucket >= 0) & (bucket < buckets)
    assert int(h.sum()) == int(in_range.sum())
    wrapped = np.zeros(buckets, np.float32)
    neg = bucket[(bucket < 0) & (bucket >= -buckets)]
    np.add.at(wrapped, neg + buckets, 1.0)
    oracle = j_is_ref(jnp.asarray(keys), n_buckets=buckets,
                      bucket_shift=shift)
    np.testing.assert_array_equal(h + wrapped, np.asarray(oracle))


# ------------------------------------------------------------------ stencil

@pytest.mark.parametrize("nx,ny,nz,bx", [
    (32, 16, 16, 8), (64, 32, 32, 16), (16, 16, 16, 16), (48, 8, 8, 8),
])
def test_stencil_plain_matches_reference(nx, ny, nz, bx):
    u = np.random.default_rng(nx + ny).standard_normal(
        (nx, ny, nz)).astype(np.float32)
    o1 = stencil7_pallas(jnp.asarray(u), bx=bx, interpret=True)
    o2 = j_st_ref(jnp.asarray(u))
    o = stencil7(torch.from_numpy(u))
    for r in (o1, o2):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5)
    o3 = stencil7(torch.from_numpy(u), coef_c=0.5, coef_n=-0.125)
    np.testing.assert_allclose(
        o3.numpy(), np.asarray(j_st_ref(jnp.asarray(u), coef_c=0.5,
                                        coef_n=-0.125)), atol=2e-5)


def test_stencil_boundary_is_dirichlet_zero():
    """Global-edge neighbours contribute zero (not wrap / clamp)."""
    u = torch.ones((16, 8, 8), dtype=torch.float32)
    out = stencil7(u)
    ref = stencil7_pallas(jnp.ones((16, 8, 8), jnp.float32), bx=8,
                          interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    # interior point: -6 + 6 = 0; corner point: -6 + 3 = -3
    assert float(out[8, 4, 4]) == pytest.approx(0.0, abs=1e-5)
    assert float(out[0, 0, 0]) == pytest.approx(-3.0, abs=1e-5)


# ----------------------------------------------------------------- dispatch

@pytest.mark.parametrize("call", [
    lambda f: ep_pairs(torch.zeros(2, 8), force=f),
    lambda f: ep_pass(torch.zeros(3, 2, 8), torch.zeros(10), torch.zeros(2),
                      force=f),
    lambda f: key_histogram(torch.zeros(8, dtype=torch.int32), n_buckets=4,
                            force=f),
    lambda f: stencil7(torch.zeros(4, 4, 4), force=f),
], ids=["ep", "ep_pass", "is_hist", "stencil7"])
def test_dispatch_modes(call):
    """``torch`` runs the plain version; the reference's Pallas modes are
    refused; ``cuda`` on a CPU tensor raises instead of falling back."""
    call("torch")
    for mode in ("pallas", "pallas_interpret", "jnp"):
        with pytest.raises(ValueError, match="modes"):
            call(mode)
    with pytest.raises(ValueError, match="CUDA tensor"):
        call("cuda")


def test_cuda_wrappers_refuse_cpu_tensors_without_counting():
    before = (ep_pass_cuda.launches, key_histogram_cuda.launches,
              stencil7_cuda.launches)
    with pytest.raises(ValueError):
        ep_pairs_cuda(torch.zeros(2, 8))
    with pytest.raises(ValueError):
        ep_pass_cuda(torch.zeros(3, 2, 8), torch.zeros(10), torch.zeros(2))
    with pytest.raises(ValueError):
        key_histogram_cuda(torch.zeros(8, dtype=torch.int32), n_buckets=4,
                           bucket_shift=0)
    with pytest.raises(ValueError):
        stencil7_cuda(torch.zeros(4, 4, 4))
    assert (ep_pass_cuda.launches, key_histogram_cuda.launches,
            stencil7_cuda.launches) == before


# ----------------------------------------------------------------- on card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2 ** 16, 2 ** 22, 0])
def test_ep_kernel_matches_plain_on_card(n):
    dev = _card()
    u = torch.from_numpy(_pairs(n, 1) if n else _edge_pairs(card=True))
    u = u.to(dev)
    h, s = ep_pairs(u)
    torch.cuda.synchronize()
    h2, s2 = ep_pairs(u, force="torch")
    assert torch.equal(h, h2)
    torch.testing.assert_close(s, s2, rtol=1e-6, atol=0, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("nb,n", [(16, 2 ** 16), (5, 1001), (1, 2 ** 16),
                                  (16, 65539), (40, 4096)])
def test_ep_pass_kernel_matches_plain_on_card(nb, n):
    """The draw pass into a carry past 2^24: counts equal the plain pass,
    sums within rtol 1e-6; and so do its batches' per-batch kernel calls
    added into the carry in order."""
    dev = _card()
    u = torch.from_numpy(np.stack([_pairs(n, i) for i in range(nb)])).to(dev)
    hist0, sums0 = (t.to(dev) for t in _carry(True))
    h, s = ep_pass(u, hist0.clone(), sums0.clone())
    torch.cuda.synchronize()
    h2, s2 = ep_pass(u, hist0.clone(), sums0.clone(), force="torch")
    assert torch.equal(h, h2)
    torch.testing.assert_close(s, s2, rtol=1e-6, atol=0)
    hl, sl = hist0, sums0
    for ub in u:
        hb, sb = ep_pairs(ub)
        hl, sl = hl + hb, sl + sb
    assert torch.equal(h, hl)
    torch.testing.assert_close(s, sl, rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("n,buckets,shift,start", [
    (2 ** 23, 1024, 16, 0), (2 ** 20, SMEM_BUCKETS * 2, 4, 0),
    (1000, 16, 10, 0), (2 ** 23, 1024, 16, 1), (1001, 1024, 16, 0),
    (3, 16, 10, 0), (4096 + 5, SMEM_BUCKETS + 1, 2, 3), (3, 1024, 4, 2),
    (2 ** 24 + 3, 1024, 16, 1)])
def test_is_kernel_matches_plain_on_card(n, buckets, shift, start):
    """The class A shape, the global-atomic path, ragged n with the first
    key ``start`` words past the tensor's (aligned) start (the kernel's
    scalar head and tail), and 2^24 + 3 keys (uint32 counts)."""
    dev = _card()
    keys = torch.from_numpy(_keys(n + start, buckets, shift, 2,
                                  out_of_range=n >= 16)).to(dev)[start:]
    h = key_histogram(keys, n_buckets=buckets, bucket_shift=shift)
    torch.cuda.synchronize()
    assert torch.equal(h, key_histogram(keys, n_buckets=buckets,
                                        bucket_shift=shift, force="torch"))


@pytest.mark.gpu
@pytest.mark.parametrize("coefs", [(-6.0, 1.0), (0.3, -0.7)])
@pytest.mark.parametrize("shape", [(24, 24, 24), (64, 64, 64), (48, 8, 8),
                                   (5, 7, 33), (1, 1, 1), (64, 1, 64),
                                   (3, 64, 5)])
def test_stencil_kernel_matches_plain_on_card(shape, coefs):
    dev = _card()
    cc, cn = coefs
    u = torch.from_numpy(np.random.default_rng(3).standard_normal(
        shape).astype(np.float32)).to(dev)
    o = stencil7(u, coef_c=cc, coef_n=cn)
    torch.cuda.synchronize()
    assert torch.equal(o, stencil7(u, coef_c=cc, coef_n=cn, force="torch"))
