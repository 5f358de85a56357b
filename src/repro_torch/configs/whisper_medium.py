"""whisper-medium [audio] — enc-dec, conv frontend (stub). [arXiv:2212.04356; unverified]
24L d_model=1024 16H d_ff=4096 vocab=51865.  The conv frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings (1500, d_model).
Whisper uses LayerNorm + GELU MLPs and absolute positions (no RoPE).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,              # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51_865,
    mlp_type="gelu",
    norm_type="layernorm",
    is_encoder_decoder=True,
    encoder_seq=1500,
    frontend="audio",
    tie_embeddings=True,
)
