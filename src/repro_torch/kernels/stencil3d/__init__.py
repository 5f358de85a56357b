from repro_torch.kernels.stencil3d.ops import stencil7
from repro_torch.kernels.stencil3d.kernel import stencil7_cuda
from repro_torch.kernels.stencil3d.ref import stencil7_ref
