"""Plain PyTorch version of the flash_attention kernel (the kernel's oracle,
and what the wrapper computes for a tensor on the CPU)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: float = 0.0) -> torch.Tensor:
    """q: (B,H,S,hd); k,v: (B,KV,S,hd).  Materialised softmax attention.

    ``scale`` defaults to ``hd ** -0.5``; the wrapper passes the unpadded
    head dim's scale when it has padded ``hd``."""
    b, h, s, hd = q.shape
    kv = k.shape[1]
    g = h // kv
    scale = scale or hd ** -0.5
    qg = q.reshape(b, kv, g, s, hd).float()
    kf = k.float()
    vf = v.float()
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg, kf) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos >= kpos
    if window:
        ok &= (qpos - kpos) < window
    logits = torch.where(ok, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, vf)
    return out.reshape(b, h, s, hd).to(q.dtype)
