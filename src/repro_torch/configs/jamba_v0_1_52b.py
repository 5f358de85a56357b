"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE.
[arXiv:2403.19887; hf]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Attention on every 8th layer (offset 3 within each 8-layer Jamba block,
per the paper's l=8, a=1 period with the attention layer mid-block);
MoE on every 2nd layer (e=2, offset 1).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65_536,
    ssm=SSMConfig(state=16, head_dim=64, expand=2, conv_kernel=4, chunk=256),
    attn_layer_period=8,
    attn_layer_offset=3,
    moe=MoEConfig(n_experts=16, top_k=2, layer_period=2, period_offset=1),
    fsdp=True,   # 52B total
    microbatches=16,  # fits-HBM (§Perf)
)
