"""phi3.5-moe-42b-a6.6b: 32L d4096 32H (GQA kv=8) d_ff=6400, MoE 16e top-2.

[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    moe_d_ff=6400,
    vocab=32064,
    n_experts=16,
    top_k=2,
    rope_theta=10_000.0,
)
