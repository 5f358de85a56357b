"""llama4-scout-17b-a16e [moe] — MoE, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=1, layer_period=1),
    fsdp=True,   # ~103B total params: FSDP over data axis required to fit
    microbatches=16,  # §Perf iteration 4: fits 16GB HBM/chip
)
