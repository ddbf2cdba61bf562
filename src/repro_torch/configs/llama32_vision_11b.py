"""llama-3.2-vision-11b: 40L d4096 32H (GQA kv=8) d_ff=14336 vocab=128256.

Cross-attn image layers every 5th layer; vision tower is a STUB --
input_specs() provides precomputed patch embeddings (B, 1601, d_model).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    cross_attn_every=5,
    n_img_tokens=1601,
    rope_theta=500_000.0,
)
