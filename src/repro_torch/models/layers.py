"""Shared neural-net layers: norms, RoPE, MLPs, initialisers (PyTorch port
of ``repro.models.layers``).

Params are plain dicts of tensors; every function is
``f(params, x, ...) -> y``.  Matmuls accumulate in f32 and cast back to the
input's dtype, as the JAX package's ``preferred_element_type`` does;
``matmul_f32out`` keeps the f32 result (logits).  The losses never hold
the (B, S, V) logits: they run one checkpointed chunk of the sequence at
a time.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.kernels import analysis


def dense_init(gen: Optional[torch.Generator], shape: Sequence[int],
               dtype: torch.dtype, scale: Optional[float] = None,
               device="cuda") -> torch.Tensor:
    """Truncated-normal fan-in init (matches common LM init).

    Values are drawn on ``gen``'s device and moved to ``device``.  On the
    ``meta`` device only the shape is made (parameter counting)."""
    dev = resolve_device(device)
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else fan_in ** -0.5
    if dev.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=dev)
    x = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (x * std).to(device=dev, dtype=dtype)


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    del x32               # one f32 copy of x less at the peak
    return (y * w.float()).to(x.dtype)


def layer_norm(params, x: torch.Tensor, eps: float = 1e-5):
    """LayerNorm with weight ``params["w"]`` and bias ``params["b"]``, in
    f32 (the population variance, as ``jnp.var``), cast back to x's
    dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["w"].float() + params["b"].float()).to(x.dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Contract the last axis of ``x`` with the first of ``w``.  PyTorch's
    bf16 GEMM accumulates in f32 and rounds once to bf16, which is what the
    JAX package's f32-accumulate-then-cast computes."""
    return torch.matmul(x, w)


class _MatmulF32Out(torch.autograd.Function):
    """bf16/f16 (N, d) x (d, V) -> (N, V) f32 on CUDA: one cuBLAS product
    with f32 accumulation and f32 output (``aten::mm.dtype``), so no f32
    copy of ``w`` is made.  ``aten::mm.dtype`` has no derivative, so the
    backward is written out: two products in the inputs' dtype with f32
    accumulation, the incoming f32 gradient rounded to that dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = torch.mm(g, w.t()) if ctx.needs_input_grad[0] else None
        gw = torch.mm(x.t(), g) if ctx.needs_input_grad[1] else None
        return gx, gw


def matmul_f32out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (contracting x's last axis with w's first) as f32, like
    the JAX package's ``dot_general(..., preferred_element_type=f32)``.

    On CUDA with 16-bit inputs it is one product with f32 accumulation
    and f32 output, so the (d, V) unembedding is never copied to f32 (a
    1 GB copy for llama3.2-1b's tied embedding).  Elsewhere (the CPU, or
    f32 inputs) it is the f32 product of the inputs."""
    if analysis.on_card(x) and x.dtype in (torch.bfloat16, torch.float16) \
            and w.dtype == x.dtype:
        lead = x.shape[:-1]
        out = _MatmulF32Out.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*lead, w.shape[-1])
    return torch.matmul(x.float(), w.float())


def matmul_rp(x: torch.Tensor, w: torch.Tensor, cfg=None) -> torch.Tensor:
    """Row-parallel matmul.  On one device there are no partial sums to
    reduce, so ``cfg.bf16_tp_reduce`` changes nothing: same as ``matmul``."""
    return matmul(x, w)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., S, hd/2)
    angles = angles[..., None, :]                              # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def init_mlp(gen, d_model: int, d_ff: int, act: str, dtype, device="cuda"):
    p = {"w1": dense_init(gen, (d_model, d_ff), dtype, device=device),
         "w2": dense_init(gen, (d_ff, d_model), dtype, device=device)}
    if act == "silu":  # SwiGLU: gate + up
        p["w3"] = dense_init(gen, (d_model, d_ff), dtype, device=device)
    return p


def mlp(params, x: torch.Tensor, act: str, cfg=None) -> torch.Tensor:
    h = matmul(x, params["w1"])
    if act == "silu":
        h = F.silu(h) * matmul(x, params["w3"])
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return matmul_rp(h, params["w2"], cfg)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab: int = 0) -> torch.Tensor:
    """Mean next-token cross-entropy in f32; labels == -1 masked out."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((lse - gold) * mask) / torch.clamp_min(mask.sum(), 1.0)


XENT_CHUNK = 512  # sequence chunk of the fused unembed+loss


def _xent_piece(xc, head, lc):
    logits = matmul_f32out(xc, head)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.clamp_min(0).long()[..., None])[..., 0]
    mask = (lc >= 0).float()
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def fused_unembed_xent(x: torch.Tensor, head: torch.Tensor,
                       labels: torch.Tensor,
                       chunk: int = XENT_CHUNK) -> torch.Tensor:
    """Cross-entropy fused with the unembedding product, chunked over the
    sequence with rematerialisation.

    Never holds the (B, S, V) logits: each chunk's (B, chunk, V) f32
    logits (``matmul_f32out``) are reduced to a loss sum under
    ``torch.utils.checkpoint``, and the backward pass recomputes them.
    This one function is the port of both ``fused_unembed_xent`` and its
    deploy-mode twin ``fused_unembed_xent_scan`` (a ``lax.scan`` over the
    same chunks): PyTorch runs the chunk loop eagerly either way.  Chunk
    sums are added in sequence order, as both JAX versions do."""
    b, s, d = x.shape
    chunk = min(chunk, s)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled() and (x.requires_grad
                                         or head.requires_grad)
    for s0 in range(0, s, chunk):
        xc, lc = x[:, s0:s0 + chunk], labels[:, s0:s0 + chunk]
        if remat:
            t, c = checkpoint(_xent_piece, xc, head, lc, use_reentrant=False)
        else:
            t, c = _xent_piece(xc, head, lc)
        total = total + t
        count = count + c
    return total / torch.clamp_min(count, 1.0)
