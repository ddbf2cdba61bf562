"""whisper-small: 12L enc + 12L dec, d768 12H (kv=12) d_ff=3072 vocab=51865.

Enc-dec; conv frontend is a STUB -- input_specs() provides precomputed
frame embeddings (B, 1500, d_model).  [arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,          # decoder layers
    n_enc_layers=12,
    enc_seq=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    act="gelu",
    rope_theta=10_000.0,
)
