from repro_torch.kernels.ep.ops import ep_pairs, ep_pass
from repro_torch.kernels.ep.kernel import ep_pairs_cuda, ep_pass_cuda
from repro_torch.kernels.ep.ref import N_ANNULI, ep_pairs_ref, ep_pass_ref
