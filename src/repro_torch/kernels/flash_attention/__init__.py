from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.kernel import (HEAD_DIMS,
                                                        flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     blocked_attention,
                                                     blocked_attention_tri,
                                                     plain_attention)
