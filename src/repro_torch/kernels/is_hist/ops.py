"""Dispatch for the IS key-histogram kernel (modes in
``repro_torch.kernels.modes``: ``cuda`` for a CUDA tensor, ``torch`` for
a CPU one).  The reference's ``block_n`` tile size changes nothing and
is not carried over."""

from __future__ import annotations

from repro_torch.kernels.is_hist.kernel import key_histogram_cuda
from repro_torch.kernels.is_hist.ref import key_histogram_ref
from repro_torch.kernels.modes import pick_mode


def key_histogram(keys, *, n_buckets: int, bucket_shift: int = 0,
                  force: str | None = None):
    """keys: [n] int32.  Returns the count of ``keys >> bucket_shift`` per
    bucket, [n_buckets] f32; out-of-range buckets are dropped."""
    fn = (key_histogram_cuda if pick_mode("is_hist", force, keys) == "cuda"
          else key_histogram_ref)
    return fn(keys, n_buckets=n_buckets, bucket_shift=bucket_shift)
