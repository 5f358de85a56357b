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

from repro.kernels.kth_free import (kth_free_batched_ref,  # noqa: E402
                                    kth_free_pallas, kth_free_pallas_batched,
                                    kth_free_ref)
from repro_torch.kernels.kth_free import (kth_free_cuda,  # noqa: E402
                                          kth_free_time,
                                          kth_free_time_batched,
                                          radix_select_kth)
from repro_torch.kernels.kth_free import kth_free_ref as t_ref  # noqa: E402

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
