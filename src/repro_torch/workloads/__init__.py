"""Runnable NPB-analogue workloads, as the reference's ``workloads``: EP,
IS and the BT/SP/LU CFD analogues, each on the run's device (CUDA unless
the caller passes ``device="cpu"``)."""

from repro_torch.device import resolve_device
from repro_torch.workloads.ep import run_ep, verify_ep, ep_flops
from repro_torch.workloads.is_sort import run_is, verify_is, is_ops
from repro_torch.workloads.cfd import (cfd_flops, cfd_iterate, cfd_u0,
                                       run_cfd, thomas_tridiag, verify_cfd)

#: sizes per scale: ``smoke`` (CI) and ``small`` (laptop) are the
#: reference's; ``A`` is NPB class A for EP (m = 28) and IS (2^23 keys),
#: and the ``small`` grid for BT/SP/LU (64^3, with NPB's 200/400/250
#: iterations cut to 20)
SCALES = {
    "smoke": {"ep_m": 18, "is_pow": 16, "cfd_nx": 24, "cfd_iters": 5},
    "small": {"ep_m": 22, "is_pow": 20, "cfd_nx": 64, "cfd_iters": 20},
    "A": {"ep_m": 28, "is_pow": 23, "cfd_nx": 64, "cfd_iters": 20},
}


def run_benchmark(name: str, scale: str = "smoke", force=None, device=None):
    """Uniform entry point: (result, verified, op count) of program
    ``name`` at ``scale`` (a key of ``SCALES``)."""
    if scale not in SCALES:
        raise ValueError(f"unknown scale {scale!r}; scales are "
                         f"{tuple(SCALES)}")
    size = SCALES[scale]
    dev = resolve_device(device)
    if name == "EP":
        m = size["ep_m"]
        res = run_ep(m=m, force=force, device=dev)
        return res, verify_ep(res), ep_flops(m)
    if name == "IS":
        n_pow = size["is_pow"]
        res = run_is(n_pow=n_pow, force=force, device=dev)
        return res, verify_is(res), is_ops(n_pow)
    if name in ("BT", "SP", "LU"):
        nx, iters = size["cfd_nx"], size["cfd_iters"]
        res = run_cfd(nx=nx, iters=iters, variant=name, force=force,
                      device=dev)
        return res, verify_cfd(res), cfd_flops(nx, iters, name)
    raise KeyError(name)


BENCHMARKS = ("BT", "EP", "IS", "LU", "SP")
