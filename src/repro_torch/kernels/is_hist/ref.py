"""Plain torch version of the IS key-histogram kernel.

Counts int32 keys by bucket ``key >> bucket_shift`` (arithmetic shift)
into ``n_buckets`` f32 counts.  Buckets that are negative or
``>= n_buckets`` are dropped, as the reference's Pallas kernel drops them
(its one-hot matches no bin); ``index_add_`` would raise on them, so they
are masked first.
"""

import torch


def key_histogram_ref(keys, *, n_buckets: int, bucket_shift: int):
    """keys: [n] int32.  Returns bucket counts [n_buckets] f32."""
    bucket = (keys >> bucket_shift).to(torch.int64)
    bucket = bucket[(bucket >= 0) & (bucket < n_buckets)]
    hist = torch.zeros(n_buckets, dtype=torch.int64, device=keys.device)
    hist.index_add_(0, bucket, torch.ones_like(bucket))
    return hist.to(torch.float32)
