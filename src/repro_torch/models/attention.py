"""GQA attention: full-sequence (prefill), blocked-causal for long
sequences, sliding-window, and single-token decode against a KV cache
(PyTorch port of ``repro.models.attention``).

Grouped-query attention is computed without materialising repeated KV
heads: queries are reshaped to (B, S, kv, group, hd) and contracted against
(B, S, kv, hd) keys directly.

Causal self-attention on a CUDA tensor always runs the hand-written
``kernels.flash_attention`` kernel.  On a CPU tensor it takes the plain
path, as the JAX package does off-TPU: ``sdpa``, or ``sdpa_blocked`` above
``BLOCK_Q`` query rows.  Decode attends one new token against the cache
with ``sdpa`` and a validity mask; the JAX package has no kernel there.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.kernels import analysis
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import apply_rope, dense_init, matmul, matmul_rp

NEG_INF = -1e30
BLOCK_Q = 1024  # blocked-causal query block


def init_attention(gen, cfg, d_model=None, device="cuda"):
    d = d_model or cfg.d_model
    hd = cfg.hd()
    dtype = cfg.torch_dtype()
    return {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), dtype, device=device),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype, device=device),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype, device=device),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), dtype, device=device),
    }


def _split_heads(x, n_heads, hd):
    return x.reshape(*x.shape[:-1], n_heads, hd)


def sdpa(q, k, v, mask=None, causal=False, window: int = 0,
         q_offset: int = 0):
    """Grouped scaled-dot-product attention.

    q: (B,Sq,H,hd);  k,v: (B,Sk,KV,hd) with KV | H;  mask broadcastable to
    (B,KV,G,Sq,Sk).  ``q_offset``: absolute position of query 0 minus
    absolute position of key 0 (used by the blocked loop).  Logits and the
    softmax are f32; probabilities are cast to q's dtype before the value
    product, as in the JAX package.
    """
    b, sq, h, hd = q.shape
    skv = k.shape[2]
    g = h // skv
    sk = k.shape[1]
    scale = hd ** -0.5
    qg = q.reshape(b, sq, skv, g, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    if causal or window:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(sk, device=q.device)[None, :]
        ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        if causal:
            ok &= qpos >= kpos
        if window:
            ok &= (qpos - kpos) < window
        logits = torch.where(ok, logits, neg)
    if mask is not None:
        logits = torch.where(mask, logits, neg)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.float(),
                       v.float()).to(q.dtype)
    return out.reshape(b, sq, h, hd)


def sdpa_blocked(q, k, v, window: int = 0, block_q: int = BLOCK_Q):
    """Causal attention via a query-block loop: each block only contracts
    against the keys its causal/window footprint allows."""
    sq = q.shape[1]
    outs = []
    for i in range(0, sq, block_q):
        hi = min(i + block_q, sq)
        lo = max(0, i - window + 1) if window else 0
        outs.append(sdpa(q[:, i:hi], k[:, lo:hi], v[:, lo:hi], causal=True,
                         window=window, q_offset=i - lo))
    return torch.cat(outs, dim=1)


def plain_causal_attention(q, k, v, window: int = 0):
    """Causal self-attention without the kernel (the CPU path, and the
    reference the kernel is held against on the card)."""
    if q.shape[1] > BLOCK_Q:
        return sdpa_blocked(q, k, v, window=window)
    return sdpa(q, k, v, causal=True, window=window)


def causal_attention(q, k, v, window: int = 0):
    """Causal self-attention: the flash kernel on CUDA (and in a card
    trace, ``kernels.analysis``), the plain path on the CPU."""
    if analysis.on_card(q):
        return fa_ops.flash_attention(q, k, v, causal=True, window=window)
    return plain_causal_attention(q, k, v, window=window)


def attention(params, x, cfg, positions, *, causal=True, window=0,
              kv_x=None, use_rope=True):
    """Full attention over a sequence (prefill).

    kv_x: optional separate kv source (cross-attention).
    Returns (out, (k, v)) so prefill can build the cache.
    """
    hd = cfg.hd()
    q = _split_heads(matmul(x, params["wq"]), cfg.n_heads, hd)
    src = kv_x if kv_x is not None else x
    k = _split_heads(matmul(src, params["wk"]), cfg.n_kv_heads, hd)
    v = _split_heads(matmul(src, params["wv"]), cfg.n_kv_heads, hd)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        if kv_x is None:
            k = apply_rope(k, positions, cfg.rope_theta)
    if causal and kv_x is None:
        out = causal_attention(q, k, v, window=window)
    else:
        out = sdpa(q, k, v, causal=False, window=window)
    out = out.reshape(*x.shape[:-1], cfg.n_heads * hd)
    return matmul_rp(out, params["wo"], cfg), (k, v)


def init_kv_cache(cfg, batch, max_len, dtype, window: int = 0,
                  device="cuda"):
    """Ring-buffer KV cache. With ``window`` the buffer is window-sized."""
    dev = resolve_device(device)
    size = min(max_len, window) if window else max_len
    hd = cfg.hd()
    shape = (batch, size, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_attention(params, x, cache, cfg, positions, *, window=0,
                     kv_x=None, use_rope=True):
    """One-token decode step: write the new K/V into the cache, attend
    over it.

    x: (B,1,d); positions: (B,1) absolute position of the new token.
    Returns (out, cache).  Unlike the JAX package, the new K/V row is
    written into ``cache`` in place (no copy of the whole buffer per
    token); the returned cache is the same dict.
    """
    hd = cfg.hd()
    q = _split_heads(matmul(x, params["wq"]), cfg.n_heads, hd)
    if kv_x is not None:
        # Cross-attention: cache holds the (static) encoder/image K/V.
        out = sdpa(q, cache["k"], cache["v"])
        out = out.reshape(*x.shape[:-1], cfg.n_heads * hd)
        return matmul_rp(out, params["wo"], cfg), cache
    k_new = _split_heads(matmul(x, params["wk"]), cfg.n_kv_heads, hd)
    v_new = _split_heads(matmul(x, params["wv"]), cfg.n_kv_heads, hd)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
    size = cache["k"].shape[1]
    pos = positions[:, 0].long()
    slot = (pos % size) if window else pos
    bidx = torch.arange(x.shape[0], device=x.device)
    cache["k"][bidx, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v_new[:, 0].to(cache["v"].dtype)
    # Valid-position mask: ring buffer slot j holds a token iff it has been
    # written and (windowed) is within ``window`` of the current position.
    p = pos[:, None]                                          # (B,1)
    j = torch.arange(size, device=x.device)[None, :]          # (1,size)
    if window:
        # slot j holds absolute position: the largest a<=p with a%size==j
        age = torch.remainder(p - j, size)
        abs_pos = p - age
        valid = (abs_pos >= 0) & (p - abs_pos < window)
    else:
        valid = j <= p
    mask = valid[:, None, None, None, :]                      # (B,KV,G,1,size)
    out = sdpa(q, cache["k"], cache["v"], mask=mask)
    out = out.reshape(*x.shape[:-1], cfg.n_heads * hd)
    return matmul_rp(out, params["wo"], cfg), cache
