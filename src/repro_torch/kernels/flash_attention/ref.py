"""Plain PyTorch version of the flash_attention kernel (the kernel's oracle,
and what the wrapper computes for a tensor on the CPU)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """q: (B,H,Sq,hd); k,v: (B,KV,Sk,hd).  Materialised softmax attention.

    ``scale`` defaults to ``hd ** -0.5``; the wrapper passes the unpadded
    head dim's scale when it has padded ``hd``.  ``q_offset`` is query 0's
    position less key 0's (``attention_ref_blocked``'s blocks)."""
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale or hd ** -0.5
    qg = q.reshape(b, kv, g, sq, hd).float()
    kf = k.float()
    vf = v.float()
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg, kf) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos >= kpos
    if window:
        ok &= (qpos - kpos) < window
    logits = torch.where(ok, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, vf)
    return out.reshape(b, h, sq, hd).to(q.dtype)


def attention_ref_blocked(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, window: int = 0,
                          scale: float = 0.0,
                          block: int = 1024) -> torch.Tensor:
    """Causal ``attention_ref`` one block of ``block`` query rows at a time,
    each against only the keys its causal window reaches: the same
    function without the (S, S) logits, which at S 32768 and above do not
    fit the card."""
    s = q.shape[2]
    outs = []
    for i in range(0, s, block):
        hi = min(i + block, s)
        lo = max(0, i - window + 1) if window else 0
        outs.append(attention_ref(q[:, :, i:hi], k[:, :, lo:hi],
                                  v[:, :, lo:hi], causal=True,
                                  window=window, scale=scale,
                                  q_offset=i - lo))
    return torch.cat(outs, dim=2)


# A planted fault of the forward kernel (csrc/flash_attention.cu, the bf16
# route) that its checks must catch: the online softmax's running sum and
# accumulator are not rescaled when a row's maximum rises.
FWD_RESCALE_FAULT = ("corr[i] = exp2f(m_r[i] - mx[i]);", "corr[i] = 1.f;")
