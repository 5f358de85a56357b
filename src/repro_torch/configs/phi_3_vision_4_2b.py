"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP (stub).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]
32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.
The CLIP frontend is a STUB: ``input_specs()`` provides precomputed patch
embeddings (n_patches, d_model) prepended to the text sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
    frontend="vision",
    n_patches=576,            # one 24x24 CLIP-L/14 tile
)
