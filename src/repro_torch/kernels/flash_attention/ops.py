"""Dispatch for the flash attention kernel (modes in
``repro_torch.kernels.modes``: ``cuda`` for CUDA tensors, ``torch`` for
CPU ones).

The ``torch`` mode is the blocked online softmax of ``ref.py``: the
triangular schedule for self-causal inputs (sq == sk), which is equal bit
for bit to the rectangular one the reference's ``ops.py`` falls back to,
and the rectangular schedule otherwise.  ``block_q`` / ``block_k`` are its
tile sizes; the CUDA kernel has tiles of its own and ignores them.

Under autograd (grad enabled and an input requiring grad) the ``cuda``
mode runs through ``kernels.autograd.KernelGrad``: forward, the CUDA
kernel unchanged; backward, the gradient of the ``torch`` mode (the same
blocked schedule and tiles) recomputed from the saved q, k, v.  The
reference has no backward kernel either: XLA differentiates its blocked
plain version.  Without autograd (serving) the kernel is called directly.
"""

from __future__ import annotations

from functools import partial

from repro_torch.kernels.autograd import KernelGrad, recording
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import (blocked_attention,
                                                     blocked_attention_tri)
from repro_torch.kernels.modes import pick_mode


def _plain(q, k, v, *, causal, block_q, block_k):
    """The ``torch`` mode: the triangular schedule for self-causal square
    tiles, else the rectangular one."""
    if causal and q.shape[1] == k.shape[1] and block_q == block_k:
        return blocked_attention_tri(q, k, v, block_q=block_q,
                                     block_k=block_k)
    return blocked_attention(q, k, v, causal=causal, block_q=block_q,
                             block_k=block_k)


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128, force: str | None = None):
    """q: [b, sq, h, hd]; k, v: [b, sk, kv, hd].  Returns [b, sq, h, hd]
    in q's dtype.  ``force``: None (by device) | 'cuda' | 'torch'."""
    plain = partial(_plain, causal=causal, block_q=block_q, block_k=block_k)
    if pick_mode("flash_attention", force, q) == "cuda":
        kernel = partial(flash_attention_cuda, causal=causal)
        if recording(q, k, v):
            return KernelGrad.apply(kernel, plain, q, k, v)
        return kernel(q, k, v)
    return plain(q, k, v)
