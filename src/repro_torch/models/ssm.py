"""Mamba2 (SSD) blocks: the chunked prefill path and the recurrent decode
(PyTorch port of ``repro.models.ssm``).

Projections are split (z / x / B / C / dt) as in the JAX package.  The
chunked scan goes through ``kernels.mamba_scan``: the hand-written kernel
on CUDA, its plain version on the CPU (the JAX package's
``cfg.use_pallas_kernels`` switch is not copied).  Decode is plain tensor
code, as in the JAX package.

State layout per layer (decode):
  conv_x/b/c: (B, d_conv-1, ·)   rolling windows of the pre-conv streams
  ssm:        (B, H, P, N)       selective state (f32)
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan.ref import ssd_chunked  # noqa: F401
from repro_torch.models.layers import dense_init, matmul, matmul_rp, rms_norm

D_CONV = 4  # depthwise conv kernel width


def dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_headdim
    return d_inner, n_heads


def init_mamba(gen, cfg, device="cuda"):
    dev = resolve_device(device)
    d = cfg.d_model
    d_inner, h = dims(cfg)
    n = cfg.ssm_state
    dtype = cfg.torch_dtype()
    dense = lambda shape, **kw: dense_init(gen, shape, dtype, device=dev,
                                           **kw)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_z": dense((d, d_inner)),
        "in_x": dense((d, d_inner)),
        "in_b": dense((d, n)),
        "in_c": dense((d, n)),
        "in_dt": dense((d, h)),
        "conv_x": dense((D_CONV, d_inner), scale=0.5),
        "conv_b": dense((D_CONV, n), scale=0.5),
        "conv_c": dense((D_CONV, n), scale=0.5),
        "dt_bias": torch.zeros((h,), **f32),
        "a_log": torch.log(torch.arange(1, h + 1, **f32)),
        "d_skip": torch.ones((h,), **f32),
        "norm_w": torch.ones((d_inner,), dtype=dtype, device=dev),
        "out_proj": dense((d_inner, d)),
    }


def _conv1d(x, w):
    """Causal depthwise conv, kernel width D_CONV.  x: (B,L,C), w: (K,C).
    Sums in f32 and rounds to x's dtype."""
    length = x.shape[1]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(D_CONV):
        shift = D_CONV - 1 - k
        xs = F.pad(x, (0, 0, shift, 0))[:, :length]
        y = y + xs.float() * w[k].float()
    return y.to(x.dtype)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))   # jax.nn.softplus


def mamba_forward(params, x, cfg) -> Tuple[torch.Tensor, dict]:
    """Full-sequence Mamba2 block. x: (B,L,d) -> (y, final_state)."""
    bs, length, _ = x.shape
    d_inner, h = dims(cfg)
    p = cfg.ssm_headdim

    def tail(r):       # the last D_CONV-1 pre-conv rows, zeros in front
        # a copy: a view would keep the whole (B, L, ·) stream alive in
        # the decode state (5.4 GB a layer for zamba2 at 524k tokens)
        return F.pad(r[:, -(D_CONV - 1):],
                     (0, 0, max(0, D_CONV - 1 - r.shape[1]), 0)).clone()

    # each stream is dropped once used: at long lengths the block's peak
    # is the sum of what is still referenced
    state = {}
    xr = matmul(x, params["in_x"])                     # pre-conv x stream
    state["conv_x"] = tail(xr)
    xs = F.silu(_conv1d(xr, params["conv_x"]))
    del xr
    br = matmul(x, params["in_b"])
    cr = matmul(x, params["in_c"])
    state["conv_b"], state["conv_c"] = tail(br), tail(cr)
    b = F.silu(_conv1d(br, params["conv_b"]))
    c = F.silu(_conv1d(cr, params["conv_c"]))
    del br, cr
    dt = _softplus(matmul(x, params["in_dt"]).float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])

    xh = xs.reshape(bs, length, h, p)
    del xs
    y, state["ssm"] = scan_ops.ssd(xh, dt, a, b, c, chunk=cfg.ssm_chunk)
    del dt, b, c
    # the skip term is added in y's dtype, after the scan rounded y
    y = y + xh.to(y.dtype) * params["d_skip"].to(y.dtype)[None, None, :,
                                                          None]
    del xh
    y = y.reshape(bs, length, d_inner) * F.silu(matmul(x, params["in_z"]))
    y = rms_norm(params["norm_w"], y, cfg.norm_eps)
    state = {k: state[k] for k in ("ssm", "conv_x", "conv_b", "conv_c")}
    return matmul_rp(y, params["out_proj"], cfg), state


def init_mamba_state(cfg, batch, dtype, device="cuda"):
    dev = resolve_device(device)
    d_inner, h = dims(cfg)
    n = cfg.ssm_state
    return {
        "conv_x": torch.zeros((batch, D_CONV - 1, d_inner), dtype=dtype,
                              device=dev),
        "conv_b": torch.zeros((batch, D_CONV - 1, n), dtype=dtype,
                              device=dev),
        "conv_c": torch.zeros((batch, D_CONV - 1, n), dtype=dtype,
                              device=dev),
        "ssm": torch.zeros((batch, h, cfg.ssm_headdim, n),
                           dtype=torch.float32, device=dev),
    }


def _conv_step(window, w):
    """window: (B,K,C) including the current input; w: (K,C) -> f32."""
    return torch.einsum("bkc,kc->bc", window.float(), w.float())


def mamba_decode(params, x, state, cfg):
    """Single-token decode. x: (B,1,d) -> (y, new_state).  ``state`` is
    not changed; the new state is returned."""
    bs = x.shape[0]
    d_inner, h = dims(cfg)
    p = cfg.ssm_headdim

    xt = x[:, 0]
    z = matmul(xt, params["in_z"])
    xr = matmul(xt, params["in_x"])
    br = matmul(xt, params["in_b"])
    cr = matmul(xt, params["in_c"])
    wx = torch.cat([state["conv_x"], xr[:, None]], dim=1)
    wb = torch.cat([state["conv_b"], br[:, None]], dim=1)
    wc = torch.cat([state["conv_c"], cr[:, None]], dim=1)
    # only xs is rounded to x's dtype; b and c stay f32
    xs = F.silu(_conv_step(wx, params["conv_x"])).to(x.dtype)
    b = F.silu(_conv_step(wb, params["conv_b"]))
    c = F.silu(_conv_step(wc, params["conv_c"]))
    dt = _softplus(matmul(xt, params["in_dt"]).float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])

    xh = xs.reshape(bs, h, p).float()
    da = torch.exp(dt * a)                                    # (B,H)
    s = state["ssm"] * da[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, b, xh)
    y = torch.einsum("bn,bhpn->bhp", c, s)
    y = y + xh * params["d_skip"][None, :, None]
    y = y.reshape(bs, d_inner).to(x.dtype) * F.silu(z)
    y = rms_norm(params["norm_w"], y, cfg.norm_eps)
    out = matmul_rp(y, params["out_proj"], cfg)[:, None]
    return out, {"ssm": s, "conv_x": wx[:, 1:], "conv_b": wb[:, 1:],
                 "conv_c": wc[:, 1:]}
