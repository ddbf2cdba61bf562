"""Mixture-of-Experts FFN: token-choice top-k router with grouped capacity
dispatch, GShard-style einsum dispatch (PyTorch port of
``repro.models.moe``).

Tokens are routed within groups of ``GROUP`` tokens; the dispatched
expert inputs are a dense (G, E, C, d) tensor that ``kernels.moe_gmm``
runs through the fused expert FFN: the hand-written kernel on CUDA, its
plain version on the CPU (the JAX package's ``cfg.use_pallas_kernels``
switch is not copied).  Either way the FFN's hidden activations stay f32
into the second product, as the JAX package's kernel path keeps them.
The JAX package's sharding pin on the expert axis is not copied: the port
has no mesh.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models.layers import dense_init

# Tokens are routed within groups of this size, so the dispatch tensor is
# (G, GROUP, E, C) with C ~ GROUP*top_k*cf/E.
GROUP = 512


def init_moe(gen, cfg, device="cuda"):
    d, e = cfg.d_model, cfg.n_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    dtype = cfg.torch_dtype()
    return {
        "router": dense_init(gen, (d, e), torch.float32, device=device),
        "w1": dense_init(gen, (e, d, ff), dtype, device=device),
        "w2": dense_init(gen, (e, ff, d), dtype, device=device),
        "w3": dense_init(gen, (e, d, ff), dtype, device=device),
    }


def expert_capacity(cfg, group: int) -> int:
    cap = int(group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(cap, cfg.top_k)  # never below top_k slots


def _route(router_w, x, cfg) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Top-k routing. x: (G,S,d) -> gates (G,S,k), idx (G,S,k), aux loss.

    ``torch.topk(sorted=True)`` orders as ``jax.lax.top_k`` does where no
    two probabilities tie."""
    logits = torch.einsum("gsd,de->gse", x.float(), router_w)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # Switch-style load-balance auxiliary loss.
    e = cfg.n_experts
    me = probs.mean(dim=(0, 1))                              # mean prob
    top1 = torch.nn.functional.one_hot(idx[..., 0], e).float()
    pe = top1.mean(dim=(0, 1))                               # top-1 share
    aux = e * torch.sum(me * pe)
    return gates, idx, aux


def _one_hot(x: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot`` in f32: all zeros where ``x`` is outside [0, n)."""
    return (x[..., None] == torch.arange(n, device=x.device,
                                         dtype=x.dtype)).float()


def _dispatch_tensors(gates, idx, cfg, capacity):
    """Dispatch (G,S,E,C) one-hot and combine (G,S,E,C) gate-weighted, both
    bf16 whatever the model's dtype, as in the JAX package.

    Position-in-expert is assigned in (s, k) priority order via a
    cumulative sum over the flattened (S*k) routing mask (GShard's
    capacity algorithm); tokens past capacity are dropped.  The k slots
    are accumulated one at a time."""
    g, s, k = idx.shape
    e = cfg.n_experts
    onehot = _one_hot(idx, e)                                # (G,S,k,E)
    flat = onehot.reshape(g, s * k, e)
    pos = torch.cumsum(flat, dim=1) - flat                   # slots before
    keep = ((pos < capacity) * flat).reshape(g, s, k, e)
    pos = pos.reshape(g, s, k, e)
    dispatch = torch.zeros((g, s, e, capacity), dtype=torch.bfloat16,
                           device=idx.device)
    combine = torch.zeros_like(dispatch)
    for kk in range(k):
        d_k = _one_hot(pos[:, :, kk], capacity) * keep[:, :, kk, :, None]
        dispatch = dispatch + d_k.to(torch.bfloat16)
        combine = combine + (gates[:, :, kk, None, None]
                             * d_k).to(torch.bfloat16)
    return dispatch, combine


def moe_ffn(params, x, cfg):
    """MoE feed-forward. x: (B,S,d) -> (y, aux_loss)."""
    b, s, d = x.shape
    tokens = b * s
    group = min(GROUP, tokens)
    if tokens % group:
        raise ValueError(f"moe_ffn: {tokens} tokens are not a multiple of "
                         f"the routing group {group} (the JAX package's "
                         "reshape fails the same way)")
    g = tokens // group
    xg = x.reshape(g, group, d)
    cap = expert_capacity(cfg, group)

    gates, idx, aux = _route(params["router"], xg, cfg)
    dispatch, combine = _dispatch_tensors(gates, idx, cfg, cap)
    # gather expert inputs: (G,E,C,d); a 16-bit product accumulates in f32
    # and rounds once, as the JAX package's preferred_element_type=f32
    xe = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
    ye = gmm_ops.expert_ffn(xe, params["w1"], params["w2"], params["w3"],
                            act=cfg.act)
    # scatter back with the (bf16-rounded) gate weights: (G,S,d)
    y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), ye)
    return y.reshape(b, s, d), cfg.router_aux_weight * aux
