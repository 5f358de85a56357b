"""mamba2-780m [ssm] — SSD (state-space duality). [arXiv:2405.21060; unverified]
48L d_model=1536 (attn-free) vocab=50280, ssm_state=128.
d_inner = 2*1536 = 3072; SSD head_dim 64 => 48 heads.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                 # no MLP: mamba2 blocks are mixer-only
    vocab_size=50_280,
    ssm=SSMConfig(state=128, head_dim=64, expand=2, conv_kernel=4, chunk=256),
    attn_layer_period=0,    # attn-free
    tie_embeddings=True,
)
