"""Plain torch version of the EP Gaussian-pair kernel.

The same per-pair arithmetic as ``csrc/ep.cu`` in separate elementwise
ops (no fused multiply-add), so each pair's deviates and annulus are
bit-equal to the kernel's.  Counts are integers; the sums of X and Y are
taken in float64 and rounded once to float32, as the kernel does.  Over a
draw pass, each batch's f32 counts and sums are added into f32 carries in
batch order, as the kernel and the reference's scan carry do.
"""

import torch

N_ANNULI = 10


def ep_pairs_ref(u):
    """u: [2, n] f32 uniforms in (-1, 1).  Returns (hist [10] f32: accepted
    pairs per annulus of floor(max(|X|, |Y|)), sums [2] f32: sum X, sum Y)."""
    x, y = u[0], u[1]
    t = x * x + y * y
    accept = (t <= 1.0) & (t > 0.0)
    t_safe = torch.where(accept, t, 1.0)
    factor = torch.sqrt(-2.0 * torch.log(t_safe) / t_safe)
    gx = torch.where(accept, x * factor, 0.0)
    gy = torch.where(accept, y * factor, 0.0)
    # clip before the conversion (fmax/fmin ignore a NaN operand), so a
    # non-finite deviate lands in the last annulus, as in the kernel
    amax = torch.fmin(torch.fmax(gx.abs(), gy.abs()),
                      torch.tensor(N_ANNULI - 1.0, device=u.device))
    annulus = amax.to(torch.int64)
    hist = torch.zeros(N_ANNULI, dtype=torch.int64, device=u.device)
    hist.index_add_(0, annulus, accept.to(torch.int64))
    sums = torch.stack([gx.double().sum(), gy.double().sum()])
    return hist.to(torch.float32), sums.to(torch.float32)


def ep_pass_ref(u, hist, sums):
    """u: [nb, 2, n] f32 uniforms; hist [10] and sums [2]: f32 carries.
    Adds the batches' ``ep_pairs_ref`` results into the carries in place
    in batch order and returns them."""
    for ub in u:
        h, s = ep_pairs_ref(ub)
        hist.add_(h)
        sums.add_(s)
    return hist, sums
