"""xlstm-1.3b: 48 blocks d2048 4H (kv=4) no FFN, sLSTM + mLSTM (xLSTM[7:1]).

[arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    slstm_every=8,       # 1-in-8 blocks are sLSTM
    xlstm_proj_factor=2.0,
)
