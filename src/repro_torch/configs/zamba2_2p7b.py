"""zamba2-2.7b: 54L d2560 32H (GQA kv=32) d_ff=10240, ssm_state=64.

Mamba2 backbone + one SHARED attention block applied every 6th layer
(paper-faithful weight sharing).  [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=64,
    shared_attn_every=6,
    rope_theta=10_000.0,
    window=4096,  # used only for the long_500k shape (see DESIGN.md)
)
