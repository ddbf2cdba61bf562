"""Shared neural-net layers: norms, RoPE, MLPs, initialisers (PyTorch port
of ``repro.models.layers``).

Params are plain dicts of tensors; every function is
``f(params, x, ...) -> y``.  Matmuls accumulate in f32 and cast back to the
input's dtype, as the JAX package's ``preferred_element_type`` does.  The
loss functions belong to the training slice and are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch import resolve_device


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
    return (y * w.float()).to(x.dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Contract the last axis of ``x`` with the first of ``w``.  PyTorch's
    bf16 GEMM accumulates in f32 and rounds once to bf16, which is what the
    JAX package's f32-accumulate-then-cast computes."""
    return torch.matmul(x, w)


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
