"""Gradients through the hand-written kernels: the forward is the CUDA
kernel, the backward the gradient of its plain torch version.

The reference has no backward kernel: its models differentiate the plain
versions (``blocked_attention[_tri]``, ``ssd_chunked``), and XLA takes
their gradients.  So the port's backward recomputes the plain version
from the saved inputs under ``torch.enable_grad()`` and returns what
autograd gives for it: bit for bit the gradient of the ``torch`` mode on
the same inputs, with no second route.  The dispatchers
(``flash_attention.ops``, ``ssd_scan.ops``) take this path in the
``cuda`` mode only while autograd records and an input requires grad;
serving calls the kernel directly.
"""

from __future__ import annotations

import torch


def recording(*tensors) -> bool:
    """Whether autograd records an op on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class KernelGrad(torch.autograd.Function):
    """``KernelGrad.apply(kernel, plain, *tensors)``: ``kernel(*tensors)``
    forward, the gradient of ``plain(*tensors)`` backward.  Both return a
    tensor or a tuple of tensors of the same layout; a kernel failure
    propagates."""

    @staticmethod
    def forward(ctx, kernel, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        return kernel(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            outs = ctx.plain(*inputs)
        if not isinstance(outs, tuple):
            outs = (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wanted = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                       [g for _, g in pairs],
                                       allow_unused=True))
        return (None, None, *(next(got) if t.requires_grad else None
                              for t in inputs))
