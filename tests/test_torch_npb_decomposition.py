"""The CUDA is_hist and stencil7 kernels' decompositions, emulated in
plain torch and held against the reference's Pallas kernels (interpret
mode) and jnp oracles, and against the port's plain versions.

The plain versions (``key_histogram_ref``, ``stencil7_ref``) compute the
same functions without the kernels' index logic: is_hist's aligned int4
body, its scalar head and tail and its per-block ranges and per-cluster
bucket slices; stencil7's (z, y, x-chunk) tiles, its x march and the halo
rows and columns that the edge warps and lanes load.  The emulations below
follow ``csrc/is_hist.cu`` and ``csrc/stencil7.cu`` index for index, with
the constants read from the sources, so that a wrong range, a missed or
doubled key or point, or a read of an unwritten tile cell shows here on
the CPU.  The card holds the kernels themselves to the plain versions
(``tests/test_torch_npb_kernels.py``'s ``gpu`` tests, ``chip_smoke.py``).

Bands: the histogram is exact; the stencil emulation equals the plain
version bit for bit and the reference within its own atol 2e-5.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

from repro.kernels.is_hist import key_histogram_pallas  # noqa: E402
from repro.kernels.stencil3d import stencil7_pallas  # noqa: E402
from repro.kernels.stencil3d import stencil7_ref as j_st_ref  # noqa: E402
from repro_torch.kernels.is_hist import (SMEM_BUCKETS,  # noqa: E402
                                         key_histogram_ref)
from repro_torch.kernels.stencil3d import stencil7_ref  # noqa: E402

_KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels"


def _constants(path):
    """The ``constexpr int kName = <literal>;`` constants of a source."""
    text = (_KERNELS / path).read_text()
    return {m[1]: int(m[2]) for m in
            re.finditer(r"constexpr int (k\w+) = (\d+);", text)}


IS = _constants("is_hist/csrc/is_hist.cu")
ST = _constants("stencil3d/csrc/stencil7.cu")


def test_constants_are_read_from_the_sources():
    assert {"kThreads", "kVecs", "kCluster"} <= set(IS)
    assert {"kTz", "kTy", "kXc", "kMaxGrid"} <= set(ST)
    assert IS["kThreads"] % 32 == 0 and ST["kTz"] == 32


# ------------------------------------------------------------------ is_hist

def _thread_vectors(length, threads, vecs):
    """The int4 offsets each thread of a block visits in a range of
    ``length`` vectors, in ``count_keys``' two loops: full steps of
    ``vecs`` loads at i, i + T, ... while i + (vecs - 1) T < length, then
    one load at a time while i < length."""
    i = torch.arange(threads)
    seen = []
    while True:
        full = i + (vecs - 1) * threads < length
        if not bool(full.any()):
            break
        seen += [i[full] + u * threads for u in range(vecs)]
        i = torch.where(full, i + vecs * threads, i)
    while True:
        more = i < length
        if not bool(more.any()):
            break
        seen.append(i[more])
        i = i + threads
    return torch.cat(seen) if seen else torch.zeros(0, dtype=torch.long)


def _is_hist_scheme(keys, n_buckets, shift, align, wave):
    """``key_histogram_launch`` on ``keys`` [n] int32 whose first key lies
    ``align`` words past a 16-byte boundary, with one wave of ``wave``
    blocks (the occupancy query's answer): returns the f32 counts and the
    number of times each key was read."""
    t, v, c = IS["kThreads"], IS["kVecs"], IS["kCluster"]
    n = keys.numel()
    counts = torch.zeros(n_buckets, dtype=torch.int64)      # the memset
    reads = torch.zeros(n, dtype=torch.int64)
    if n == 0:
        return counts.float(), reads
    head = min(n, (4 - align) % 4)
    n4 = (n - head) // 4
    tail = n - head - 4 * n4
    cluster = n_buckets <= SMEM_BUCKETS
    blocks = -(-n4 // (t * v))
    if cluster:
        blocks = -(-blocks // c) * c
    blocks = max(min(blocks, wave), c if cluster else 1)
    per_block = -(-n4 // blocks)

    def hist(idx):
        reads.index_add_(0, idx, torch.ones_like(idx))
        b = keys[idx].long() >> shift
        b = b[(b >= 0) & (b < n_buckets)]
        return torch.zeros(n_buckets, dtype=torch.int64).index_add_(
            0, b, torch.ones_like(b))

    block_hist = []
    for blk in range(blocks):
        idx = [torch.zeros(0, dtype=torch.long)]
        if blk == 0:
            idx += [torch.arange(head), head + 4 * n4 + torch.arange(tail)]
        start = blk * per_block
        length = max(0, min(per_block, n4 - start))
        vec = start + _thread_vectors(length, t, v)
        idx.append((head + 4 * vec[:, None] + torch.arange(4)).reshape(-1))
        block_hist.append(hist(torch.cat(idx)))
    if cluster:
        # block r of each cluster adds slice r of the cluster's histograms
        slice_ = -(-n_buckets // c)
        for first in range(0, blocks, c):
            for r in range(c):
                lo, hi = r * slice_, min(n_buckets, (r + 1) * slice_)
                if lo < hi:
                    counts[lo:hi] += sum(h[lo:hi]
                                         for h in block_hist[first:first + c])
    else:
        counts += sum(block_hist)
    return counts.float(), reads


def _is_keys(n, buckets, shift, seed):
    """Keys over [0, buckets << shift) with a tenth out of range (negative
    or too large, dropped by every version)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, buckets << shift, n).astype(np.int32)
    wild = rng.random(n) < 0.1
    keys[wild] = rng.integers(-2 ** 31, 2 ** 31 - 1, int(wild.sum()))
    return keys


def _pallas_hist(keys, buckets, shift):
    """The reference kernel in interpret mode, in grid steps of at most
    ~8k keys that divide n (its contract)."""
    n = keys.shape[0]
    block = next(d for d in range(min(n, 8193), 0, -1) if n % d == 0)
    return np.asarray(key_histogram_pallas(
        jnp.asarray(keys), n_buckets=buckets, bucket_shift=shift,
        block_n=block, interpret=True))


@pytest.mark.parametrize("buckets", [16, 1024, SMEM_BUCKETS + 1])
@pytest.mark.parametrize("n", [1, 3, 1001, 4096 + 5])
def test_is_hist_scheme_matches_reference(n, buckets):
    """Every 16-byte offset of the first key (keys[off:] of an aligned
    tensor) and two waves: each key is read once, and the counts equal the
    reference's kernel, exactly."""
    shift = 3
    keys = _is_keys(n, buckets, shift, n + buckets)
    want = _pallas_hist(keys, buckets, shift)
    t_keys = torch.from_numpy(keys)
    np.testing.assert_array_equal(
        key_histogram_ref(t_keys, n_buckets=buckets,
                          bucket_shift=shift).numpy(), want)
    for align in range(4):
        for wave in (IS["kCluster"], 4 * 132):
            got, reads = _is_hist_scheme(t_keys, buckets, shift, align, wave)
            assert torch.equal(reads, torch.ones_like(reads)), (align, wave)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("wave", [8, 16])
@pytest.mark.parametrize("align", [0, 1, 2])
def test_is_hist_scheme_runs_its_vector_loop(align, wave):
    """Ranges long enough for the full kVecs-load steps, with a ragged
    remainder: 81,925 keys over one or two clusters (at most ``wave``
    blocks, so each range holds at least n4 / wave vectors)."""
    n, buckets, shift = 81925, 1024, 5
    assert (n - 3) // 4 // wave > (IS["kVecs"] - 1) * IS["kThreads"]
    keys = _is_keys(n, buckets, shift, 7)
    got, reads = _is_hist_scheme(torch.from_numpy(keys), buckets, shift,
                                 align, wave)
    assert torch.equal(reads, torch.ones_like(reads))
    np.testing.assert_array_equal(got.numpy(),
                                  _pallas_hist(keys, buckets, shift))


def test_is_hist_scheme_with_no_keys_is_zeros():
    got, _ = _is_hist_scheme(torch.zeros(0, dtype=torch.int32), 16, 0, 0, 8)
    assert torch.equal(got, key_histogram_ref(
        torch.zeros(0, dtype=torch.int32), n_buckets=16, bucket_shift=0))


# ----------------------------------------------------------------- stencil7

def _stencil_scheme(u, coef_c, coef_n, grid_cap=None):
    """``stencil7_launch`` on a [nx, ny, nz] f32 grid: the 3-D grid of
    (z tile, y tile, x chunk) blocks, capped at ``grid_cap`` in y and x
    (the launch's 65,535 unless given) with the kernel's strided loops
    over the rest; per block the threads' column loads, the tile with its
    halo (cells never written are NaN, as shared memory is undefined) and
    the sum in the kernel's order.  Returns the output and the number of
    writes of each point."""
    tz_n, ty_n, xc_n = ST["kTz"], ST["kTy"], ST["kXc"]
    cap = ST["kMaxGrid"] if grid_cap is None else grid_cap
    nx, ny, nz = u.shape
    flat = u.reshape(-1)
    out = torch.full_like(flat, float("nan"))
    writes = torch.zeros(flat.numel(), dtype=torch.int64)
    plane = ny * nz
    ny_tiles, nx_chunks = (ny - 1) // ty_n + 1, (nx - 1) // xc_n + 1
    grid = ((nz - 1) // tz_n + 1, min(ny_tiles, cap), min(nx_chunks, cap))
    ty, tz = torch.meshgrid(torch.arange(ty_n), torch.arange(tz_n),
                            indexing="ij")

    def load(idx, ok):
        return torch.where(ok, flat[idx.clamp(0, flat.numel() - 1)],
                           torch.zeros(()))

    edge_lane = (tz == 0) | (tz == tz_n - 1)
    dy = torch.where(ty == 0, -1, torch.where(ty == ty_n - 1, 1, 0))
    hy = torch.where(ty == 0, 0, ty_n + 1)
    hz = torch.where(tz == 0, 0, tz_n + 1)
    for bx in range(grid[0]):
        k = bx * tz_n + tz
        kh = torch.where(tz == 0, k - 1, torch.where(tz == tz_n - 1, k + 1,
                                                     -1))
        k_in, kh_in = k < nz, (kh >= 0) & (kh < nz)
        for by in range(grid[1]):
            for bz in range(grid[2]):
                for xc in range(bz, nx_chunks, grid[2]):
                    for yt in range(by, ny_tiles, grid[1]):
                        x0, j = xc * xc_n, yt * ty_n + ty
                        inside = k_in & (j < ny)
                        at = (x0 * ny + j) * nz + k
                        col = [load(at + (q - 1) * plane,
                                    inside & (0 <= x0 - 1 + q)
                                    & (x0 - 1 + q < nx))
                               for q in range(xc_n + 2)]
                        jh = j + dy
                        yh_in = (dy != 0) & k_in & (jh >= 0) & (jh < ny)
                        zh_in = kh_in & (j < ny)
                        s = torch.full((xc_n, ty_n + 2, tz_n + 2),
                                       float("nan"))
                        for q in range(xc_n):
                            x_in = x0 + q < nx
                            s[q, ty + 1, tz + 1] = col[q + 1]
                            m = dy != 0
                            s[q, hy[m], tz[m] + 1] = load(
                                at + q * plane + dy * nz, yh_in & x_in)[m]
                            s[q, ty[edge_lane] + 1, hz[edge_lane]] = load(
                                at + q * plane + (kh - k),
                                zh_in & x_in)[edge_lane]
                        for q in range(xc_n):
                            if x0 + q >= nx:
                                continue
                            total = col[q] + col[q + 2]
                            total = total + s[q, ty + 2, tz + 1]
                            total = total + s[q, ty, tz + 1]
                            total = total + s[q, ty + 1, tz + 2]
                            total = total + s[q, ty + 1, tz]
                            res = coef_c * col[q + 1] + coef_n * total
                            idx = (at + q * plane)[inside]
                            out[idx] = res[inside]
                            writes.index_add_(0, idx, torch.ones_like(idx))
    return out.view(nx, ny, nz), writes


@pytest.mark.parametrize("coefs", [(-6.0, 1.0), (0.3, -0.7)])
@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 7, 33), (64, 1, 64),
                                   (3, 64, 5), (24, 24, 24)])
def test_stencil_scheme_matches_reference(shape, coefs):
    """Each point is written once, bit-equal to the plain version, and
    within the reference's atol 2e-5 of its kernel and oracle; also with
    the launch's grid capped at 2 blocks in y and x, so that blocks walk
    over several tiles and chunks."""
    cc, cn = coefs
    u = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    t = torch.from_numpy(u)
    plain = stencil7_ref(t, coef_c=cc, coef_n=cn)
    bx = next(d for d in range(min(16, shape[0]), 0, -1) if shape[0] % d == 0)
    pal = stencil7_pallas(jnp.asarray(u), coef_c=cc, coef_n=cn, bx=bx,
                          interpret=True)
    oracle = j_st_ref(jnp.asarray(u), coef_c=cc, coef_n=cn)
    for cap in (None, 2):
        got, writes = _stencil_scheme(t, cc, cn, cap)
        assert torch.equal(writes, torch.ones_like(writes)), cap
        assert torch.equal(got, plain), cap
        for ref in (pal, oracle):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=2e-5)


def test_stencil_scheme_boundary_is_dirichlet_zero():
    """Ones on a grid whose y and z edges cut through the tiles: every
    face point loses its outside neighbour (interior 0, corner -3)."""
    got, _ = _stencil_scheme(torch.ones((9, 10, 35)), -6.0, 1.0)
    assert float(got[4, 5, 17]) == 0.0 and float(got[0, 0, 0]) == -3.0
    assert float(got[8, 9, 34]) == -3.0 and float(got[4, 0, 17]) == -1.0
    assert torch.equal(got, stencil7_ref(torch.ones((9, 10, 35))))
