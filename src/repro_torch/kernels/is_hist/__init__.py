from repro_torch.kernels.is_hist.ops import key_histogram
from repro_torch.kernels.is_hist.kernel import SMEM_BUCKETS, key_histogram_cuda
from repro_torch.kernels.is_hist.ref import key_histogram_ref
