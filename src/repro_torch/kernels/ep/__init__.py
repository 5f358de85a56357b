from repro_torch.kernels.ep.ops import ep_pairs
from repro_torch.kernels.ep.kernel import ep_pairs_cuda
from repro_torch.kernels.ep.ref import N_ANNULI, ep_pairs_ref
