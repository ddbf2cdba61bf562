"""--arch <id> registry: resolves architecture ids to ArchConfig objects."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b_a6p6b",
    "llama3.2-1b": "llama32_1b",
    "llama3.2-3b": "llama32_3b",
    "glm4-9b": "glm4_9b",
    "minitron-4b": "minitron_4b",
    "zamba2-2.7b": "zamba2_2p7b",
    "xlstm-1.3b": "xlstm_1p3b",
    "whisper-small": "whisper_small",
    "llama-3.2-vision-11b": "llama32_vision_11b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def reduced_config(arch_id: str) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (small layers/width/experts)."""
    cfg = get_config(arch_id)
    kw = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        head_dim=16,
        remat=False,
        scan_layers=False,
        dtype="float32",
    )
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=2, moe_d_ff=64)
    if cfg.family == "hybrid":
        kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32,
                  shared_attn_every=2, n_layers=4)
    if cfg.family == "ssm":
        kw.update(slstm_every=2, n_layers=4)
    if cfg.family == "audio":
        kw.update(n_enc_layers=2, enc_seq=32)
    if cfg.family == "vlm":
        kw.update(cross_attn_every=2, n_img_tokens=16)
    return cfg.with_(**kw)
