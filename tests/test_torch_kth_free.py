"""Port parity: the kth-free radix select (repro_torch.kernels.kth_free)
against the reference's Pallas kernel (interpret mode) and sort oracle.

The selected value is an element of the input, so every comparison is
exact.  On the CPU the port's dispatch runs its torch twin; the CUDA
kernel itself is held against the twin on the card (the ``gpu`` test
below, and ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from _jax_caches import release_compiled  # noqa: E402,F401

from repro.kernels.kth_free import (kth_free_batched_ref,  # noqa: E402
                                    kth_free_pallas, kth_free_pallas_batched,
                                    kth_free_ref)
from repro.kernels.kth_free import radix_select_kth as j_radix  # noqa: E402
from repro.kernels.kth_free.ops import (  # noqa: E402
    kth_free_time_rows as j_rows, kth_free_time_shared as j_shared)
from repro_torch.kernels.kth_free import (kth_free_cuda,  # noqa: E402
                                          kth_free_time,
                                          kth_free_time_batched,
                                          kth_free_time_rows,
                                          kth_free_time_shared,
                                          radix_select_kth)
from repro_torch.kernels.kth_free import kth_free_ref as t_ref  # noqa: E402
from repro_torch.kernels.kth_free.kernel import (  # noqa: E402
    _f32_to_ordered_u32, _ordered_u32_to_f32)

BIG = 1e30


def _case(shape, seed, sentinel_row=False, negative=False):
    """Random node-free table with BIG padding, idle (0.0) ties and
    optionally an all-BIG row and negative times; n_req in [1, maxN]."""
    rng = np.random.default_rng(seed)
    free = rng.uniform(0, 1e6, shape).astype(np.float32)
    free[rng.random(shape) < 0.3] = BIG
    free[rng.random(shape) < 0.3] = 0.0
    if negative:
        free[rng.random(shape) < 0.2] = -rng.uniform(0, 1e3)
    if sentinel_row:
        free.reshape(-1, shape[-1])[0] = BIG
    nreq = rng.integers(1, shape[-1] + 1, shape[:-1]).astype(np.int32)
    return free, nreq


def _edge_case(n, seed=2):
    """The edge rows of ``chip_smoke.py``'s kernel phase at width n: an
    all-BIG row, ties, negative times, -0.5 every other column, and n_req
    of 0, -7, n + 1 and 10^6 (clipped to [1, n])."""
    free, nreq = _case((10, 4, n), seed)
    rng = np.random.default_rng(seed + 1)
    free[0] = BIG
    free[1] = rng.integers(0, 3, free[1].shape).astype(np.float32)
    free[2] = -rng.uniform(0, 1e3, free[2].shape).astype(np.float32)
    free[3, :, ::2] = -0.5
    nreq[4], nreq[5], nreq[6], nreq[7] = 0, -7, n + 1, 10 ** 6
    return free, nreq


def _rank_select(node_free, n_req):
    """Plain torch emulation of the CUDA rank kernel (rows of up to 256
    nodes): per key, lt = #{keys below it} on the order-preserving uint32
    keys; the keys with lt < k are candidates and the largest of them is
    the k-th smallest."""
    n = node_free.shape[-1]
    u = _f32_to_ordered_u32(node_free)
    k = n_req.to(torch.int64).clamp(1, n).unsqueeze(-1)
    lt = (u.unsqueeze(-2) < u.unsqueeze(-1)).sum(-1)
    return _ordered_u32_to_f32(torch.where(lt < k, u, 0).amax(-1))


def _port_modes(free, nreq):
    f, n = torch.from_numpy(free), torch.from_numpy(nreq)
    return {"auto": kth_free_time(f, n).numpy(),
            "torch": kth_free_time(f, n, force="torch").numpy(),
            "sort": kth_free_time(f, n, force="sort").numpy()}


@pytest.mark.parametrize("s,n,seed", [
    (4, 136, 0),      # the JSCC node matrix
    (2, 8, 1),
    (7, 200, 2),
    (3, 129, 3),      # non-multiple-of-lane width
])
def test_kth_free_sweep_matches_reference(s, n, seed):
    free, nreq = _case((s, n), seed, negative=seed == 2)
    ref = np.asarray(kth_free_ref(jnp.asarray(free), jnp.asarray(nreq)))
    pal = np.asarray(kth_free_pallas(jnp.asarray(free), jnp.asarray(nreq),
                                     interpret=True))
    np.testing.assert_array_equal(ref, pal)
    for mode, out in _port_modes(free, nreq).items():
        np.testing.assert_array_equal(out, ref, err_msg=mode)


@pytest.mark.parametrize("wn,s,n,seed", [
    (1, 4, 136, 0),       # W=1 degenerate candidate batch
    (9, 4, 136, 1),       # JSCC node matrix, default EASY window + head
    (17, 3, 129, 2),      # W=16 window, non-multiple-of-lane width
    (5, 2, 8, 3),
    (33, 7, 200, 4),      # W=32 window, wide stack
])
def test_kth_free_batched_matches_reference(wn, s, n, seed):
    free, nreq = _case((wn, s, n), seed, sentinel_row=True)
    ref = np.asarray(kth_free_batched_ref(jnp.asarray(free),
                                          jnp.asarray(nreq)))
    pal = np.asarray(kth_free_pallas_batched(
        jnp.asarray(free), jnp.asarray(nreq), interpret=True))
    np.testing.assert_array_equal(ref, pal)
    for mode, out in _port_modes(free, nreq).items():
        np.testing.assert_array_equal(out, ref, err_msg=mode)
    # the batched entry is the same function over one more dimension
    f, q = torch.from_numpy(free), torch.from_numpy(nreq)
    np.testing.assert_array_equal(kth_free_time_batched(f, q).numpy(), ref)


def test_kth_free_grid_lanes_match_per_lane_reference():
    """The engine's [B, S, maxN] call equals B reference calls."""
    free, nreq = _case((20, 4, 136), 7, sentinel_row=True)
    out = radix_select_kth(torch.from_numpy(free), torch.from_numpy(nreq))
    for b in range(20):
        ref = kth_free_pallas(jnp.asarray(free[b]), jnp.asarray(nreq[b]),
                              interpret=True)
        np.testing.assert_array_equal(out[b].numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", [20, 136, 1000])
def test_rank_scheme_matches_sort_and_radix_on_edge_rows(n):
    """The rank kernel's scheme, emulated, equals the port's sort oracle
    and radix select and the reference's radix select on the edge rows,
    bit for bit (the selected value is an input element)."""
    free, nreq = _edge_case(n)
    f, q = torch.from_numpy(free), torch.from_numpy(nreq)
    rank = _rank_select(f, q)
    assert torch.equal(rank, t_ref(f, q))
    assert torch.equal(rank, radix_select_kth(f, q))
    ref = np.stack([np.asarray(j_radix(jnp.asarray(free[i]),
                                       jnp.asarray(nreq[i])))
                    for i in range(free.shape[0])])
    np.testing.assert_array_equal(rank.numpy().view(np.uint32),
                                  ref.view(np.uint32))
    assert np.all(rank.numpy()[0] == BIG)


@pytest.mark.parametrize("shape,seed", [((20, 4, 136), 0),
                                        ((20, 17, 4, 136), 1),
                                        ((5, 3, 20), 4), ((3, 256), 5),
                                        ((6, 129), 6)])
def test_rank_scheme_matches_reference_on_random_rows(shape, seed):
    """The campaign step's and the EASY window's shapes, a narrow row, the
    widest row the rank kernel takes (256) and a non-multiple-of-4 row."""
    free, nreq = _case(shape, seed, sentinel_row=True, negative=True)
    f, q = torch.from_numpy(free), torch.from_numpy(nreq)
    rank = _rank_select(f, q)
    assert torch.equal(rank, radix_select_kth(f, q))
    flat_f, flat_q = free.reshape(-1, shape[-1]), nreq.reshape(-1)
    ref = np.asarray(kth_free_ref(jnp.asarray(flat_f), jnp.asarray(flat_q)))
    np.testing.assert_array_equal(rank.numpy().reshape(-1).view(np.uint32),
                                  ref.view(np.uint32))


def test_rank_scheme_keeps_the_sign_of_zero():
    """-0.0 sorts below +0.0 on the uint32 keys, in both schemes."""
    f = torch.tensor([[0.0, -0.0, 0.0, 1.0], [-0.0, -0.0, 0.0, 0.0]])
    for k in range(1, 5):
        q = torch.tensor([k, k], dtype=torch.int32)
        a, b = _rank_select(f, q), radix_select_kth(f, q)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("fn", [radix_select_kth, t_ref])
def test_kth_free_clips_out_of_range_requests(fn):
    free = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    nreq = torch.tensor([0, 99], dtype=torch.int32)
    np.testing.assert_array_equal(fn(free, nreq).numpy(), [0.0, 11.0])
    np.testing.assert_array_equal(
        fn(free, torch.tensor([-5, 6], dtype=torch.int32)).numpy(),
        [0.0, 11.0])


def test_kth_free_all_big_rows_return_big():
    free = torch.full((3, 4, 136), BIG, dtype=torch.float32)
    nreq = torch.tensor([[1, 5, 136, 200]] * 3, dtype=torch.int32)
    for mode in ("torch", "sort"):
        out = kth_free_time(free, nreq, force=mode)
        assert torch.equal(out, torch.full((3, 4), BIG, dtype=torch.float32))


@pytest.mark.parametrize("mode", ["pallas", "pallas_interpret", "jnp"])
def test_reference_only_modes_raise(mode):
    free, nreq = _case((4, 136), 0)
    with pytest.raises(ValueError, match="unknown kth_free mode"):
        kth_free_time(torch.from_numpy(free), torch.from_numpy(nreq),
                      force=mode)


def test_cuda_kernel_refuses_cpu_tensors():
    """A CPU tensor never reaches the CUDA wrapper silently: forcing the
    kernel on one raises instead of falling back to the twin."""
    free, nreq = _case((4, 136), 0)
    before = kth_free_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        kth_free_time(torch.from_numpy(free), torch.from_numpy(nreq),
                      force="cuda")
    assert kth_free_cuda.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(20, 4, 136), (20, 17, 4, 136),
                                   (3, 7, 200), (2, 3, 1000)])
def test_cuda_kernel_matches_twin_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    free, nreq = _case(shape, 11, sentinel_row=True, negative=True)
    f = torch.from_numpy(free).cuda()
    n = torch.from_numpy(nreq).cuda()
    n[..., 0] = 0                                    # clip from below
    n[..., -1] = shape[-1] + 7                       # clip from above
    out = kth_free_time(f, n)
    torch.cuda.synchronize()
    assert torch.equal(out, kth_free_time(f, n, force="torch"))
    assert torch.equal(out, kth_free_time(f, n, force="sort"))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [20, 136, 256, 257, 1000])
def test_cuda_kernel_edge_rows_on_card(n):
    """The edge rows on the card, on both sides of the rank kernel's 256
    limit: kernel == radix select == sort, bit for bit, and a
    non-contiguous view equals its contiguous copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    free, nreq = _edge_case(n)
    f = torch.from_numpy(free).cuda()
    q = torch.from_numpy(nreq).cuda()
    out = kth_free_cuda(f, q)
    torch.cuda.synchronize()
    bits = out.view(torch.int32)
    assert torch.equal(bits, radix_select_kth(f, q).view(torch.int32))
    assert torch.equal(out, t_ref(f, q))
    view = f.transpose(0, 1)
    assert torch.equal(kth_free_cuda(view, q.transpose(0, 1)),
                       out.transpose(0, 1))


def _clipped(nreq, n, rng):
    """Requests with clipped entries mixed in: 0, negative, n + 1 and
    far above n (the entries clip to [1, n])."""
    q = nreq.copy()
    flat = q.reshape(-1)
    pick = rng.permutation(flat.size)[:4 * max(1, flat.size // 8)]
    flat[pick] = np.resize(np.array([0, -3, n + 1, 10 ** 6], np.int32),
                           pick.size)
    return q


@pytest.mark.parametrize("b,wn,s,n,seed", [
    (1, 17, 4, 136, 0),   # the EASY window of one lane at the JSCC widths
    (3, 9, 4, 136, 1),    # grid lanes
    (2, 1, 3, 20, 2),     # W = 1
    (2, 5, 7, 200, 3),
])
def test_kth_free_shared_matches_reference_sort(b, wn, s, n, seed):
    """Many requests against one table per lane: every port mode equals
    the reference's ``kth_free_time_shared(force="sort")`` lane by lane,
    including clipped requests."""
    rng = np.random.default_rng(seed)
    free, _ = _case((b, s, n), seed, sentinel_row=True, negative=True)
    nreq = _clipped(rng.integers(1, n + 1, (b, wn, s)).astype(np.int32), n,
                    rng)
    ref = np.stack([np.asarray(j_shared(jnp.asarray(free[i]),
                                        jnp.asarray(nreq[i]), force="sort"))
                    for i in range(b)])
    f, q = torch.from_numpy(free), torch.from_numpy(nreq)
    for mode in (None, "torch", "sort"):
        out = kth_free_time_shared(f, q, force=mode)
        assert out.shape == (b, wn, s)
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=str(mode))
    # one table without lanes
    np.testing.assert_array_equal(
        kth_free_time_shared(f[0], q[0]).numpy(), ref[0])


@pytest.mark.parametrize("b,wn,s,n,seed", [
    (1, 17, 4, 136, 0),
    (3, 9, 4, 136, 1),
    (2, 1, 3, 20, 2),
    (2, 33, 7, 200, 3),   # slots outnumber systems: reserved rows repeat
])
def test_kth_free_rows_matches_reference_sort(b, wn, s, n, seed):
    """One request per slot on its own reserved system: every port mode
    equals the reference's ``kth_free_time_rows(force="sort")``."""
    rng = np.random.default_rng(seed)
    free, _ = _case((b, s, n), seed, sentinel_row=True, negative=True)
    sels = rng.integers(0, s, (b, wn)).astype(np.int32)
    nreq = _clipped(rng.integers(1, n + 1, (b, wn)).astype(np.int32), n, rng)
    ref = np.stack([np.asarray(j_rows(jnp.asarray(free[i]),
                                      jnp.asarray(sels[i]),
                                      jnp.asarray(nreq[i]), force="sort"))
                    for i in range(b)])
    f, q = torch.from_numpy(free), torch.from_numpy(nreq)
    sl = torch.from_numpy(sels)
    for mode in (None, "torch", "sort"):
        out = kth_free_time_rows(f, sl, q, force=mode)
        assert out.shape == (b, wn)
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=str(mode))
    np.testing.assert_array_equal(
        kth_free_time_rows(f[0], sl[0], q[0]).numpy(), ref[0])


def test_shared_entries_refuse_cuda_on_cpu_and_bad_modes():
    free, nreq = _case((2, 4, 136), 0)
    f = torch.from_numpy(free)
    q = torch.from_numpy(nreq).unsqueeze(1).expand(2, 3, 4)
    before = kth_free_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        kth_free_time_shared(f, q, force="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        kth_free_time_rows(f, torch.zeros((2, 3), dtype=torch.int64),
                           q[..., 0], force="cuda")
    assert kth_free_cuda.launches == before
    with pytest.raises(ValueError, match="modes"):
        kth_free_time_shared(f, q, force="pallas")


@pytest.mark.gpu
def test_shared_entries_on_card():
    """The EASY step's two shapes on the card: the kernel (the default)
    equals the sort mode bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(5)
    free, _ = _case((20, 4, 136), 5, sentinel_row=True, negative=True)
    f = torch.from_numpy(free).cuda()
    q = torch.from_numpy(_clipped(rng.integers(1, 137, (20, 17, 4)).astype(
        np.int32), 136, rng)).cuda()
    sl = torch.from_numpy(rng.integers(0, 4, (20, 17))).cuda()
    assert torch.equal(kth_free_time_shared(f, q),
                       kth_free_time_shared(f, q, force="sort"))
    assert torch.equal(kth_free_time_rows(f, sl, q[..., 0]),
                       kth_free_time_rows(f, sl, q[..., 0], force="sort"))
