"""Full-sort oracle for the kth-free-time kernel.

Per row, the n_req-th smallest entry of the node-free row, found the
obvious way: sort the row and gather the kth column.  The kernel and its
plain twin answer without sorting; all three agree bit for bit, because
the answer is an element of the input.
"""

import torch


def kth_free_ref(node_free, n_req):
    """node_free: [..., S, maxN] f32; n_req: [..., S] int (1-indexed count,
    clipped to [1, maxN]).  Returns [..., S] f32."""
    n = node_free.shape[-1]
    idx = (n_req.to(torch.int64) - 1).clamp(0, n - 1)
    srt = torch.sort(node_free, dim=-1).values
    return srt.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
