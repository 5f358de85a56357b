from repro_torch.kernels.kth_free.ops import (kth_free_time,
                                              kth_free_time_batched)
from repro_torch.kernels.kth_free.kernel import (kth_free_cuda,
                                                 radix_select_kth)
from repro_torch.kernels.kth_free.ref import kth_free_ref
