"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential recurrence) (PyTorch port of
``repro.models.xlstm``).

Prefill runs the stabilised chunkwise mLSTM through ``kernels.mlstm``:
the hand-written kernel on CUDA, its plain version on the CPU (the JAX
package's ``cfg.use_pallas_kernels`` switch is not copied).  Unlike the
JAX package's Pallas path, the kernel takes the initial state and a
length that is not a multiple of the chunk.  Decode is plain tensor code,
as in the JAX package.

sLSTM carries a true hidden-state recurrence (h feeds the gates), so the
sequence runs as a Python loop over tokens (the JAX package's
``lax.scan``); per-head recurrent weights are block-diagonal.

State layout per layer (decode):
  mLSTM: c (B,H,hd,hd) f32, n (B,H,hd) f32, m (B,H) f32,
         conv (B,D_CONV-1,du) the pre-conv stream's last rows
  sLSTM: c, n, h, m (B,d) f32
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels.mlstm import ops as mlstm_ops
from repro_torch.kernels.mlstm.ref import (CHUNK, NEG,  # noqa: F401
                                           mlstm_chunk_body, mlstm_chunked)
from repro_torch.models.layers import dense_init, matmul, matmul_rp, rms_norm

D_CONV = 4


def mlstm_dims(cfg):
    du = int(cfg.xlstm_proj_factor * cfg.d_model)
    hd = du // cfg.n_heads
    return du, hd


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def init_mlstm(gen, cfg, device="cuda"):
    dev = resolve_device(device)
    d = cfg.d_model
    du, hd = mlstm_dims(cfg)
    h = cfg.n_heads
    dtype = cfg.torch_dtype()
    dense = lambda shape, dt=dtype, **kw: dense_init(gen, shape, dt,
                                                     device=dev, **kw)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "up_x": dense((d, du)),
        "up_z": dense((d, du)),
        "conv_w": dense((D_CONV, du), scale=0.5),
        # block-diagonal per-head q/k/v (mLSTM cells are head-independent)
        "wq": dense((h, hd, hd), scale=hd ** -0.5),
        "wk": dense((h, hd, hd), scale=hd ** -0.5),
        "wv": dense((h, hd, hd), scale=hd ** -0.5),
        "wi": dense((du, h), torch.float32),
        "wf": dense((du, h), torch.float32),
        "bi": torch.zeros((h,), **f32),
        "bf": torch.full((h,), 3.0, **f32),   # open forget gates at init
        "skip": torch.ones((du,), dtype=dtype, device=dev),
        "norm_w": torch.ones((du,), dtype=dtype, device=dev),
        "down": dense((du, d)),
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


def _heads(x, h, hd):
    return x.reshape(*x.shape[:-1], h, hd)


def _gates(params, xm):
    xf = xm.float()
    logi = torch.log(torch.sigmoid(xf @ params["wi"] + params["bi"]) + 1e-9)
    logf = torch.log(torch.sigmoid(xf @ params["wf"] + params["bf"]) + 1e-9)
    return logi, logf


def mlstm_forward(params, x, cfg, state=None) -> Tuple[torch.Tensor, dict]:
    """Full-sequence mLSTM block body. x: (B,L,d) -> (y, final state).

    ``state`` (a decode state's c, n, m) is where the scan starts; the
    JAX package's Pallas path drops it and starts from zero."""
    bs, length, _ = x.shape
    du, hd = mlstm_dims(cfg)
    h = cfg.n_heads
    xm = matmul(x, params["up_x"])
    z = matmul(x, params["up_z"])
    xc = F.silu(_conv1d(xm, params["conv_w"]))
    q = torch.einsum("blhd,hde->blhe", _heads(xc, h, hd), params["wq"])
    k = torch.einsum("blhd,hde->blhe", _heads(xc, h, hd), params["wk"])
    v = torch.einsum("blhd,hde->blhe", _heads(xm, h, hd), params["wv"])
    logi, logf = _gates(params, xm)
    st = None
    if state is not None:
        st = (state["c"], state["n"], state["m"])
    ht, st_fin = mlstm_ops.mlstm(q, k, v, logi, logf, st)
    ht = ht.reshape(bs, length, du) + params["skip"] * xc
    y = rms_norm(params["norm_w"], ht, cfg.norm_eps) * F.silu(z)
    conv_tail = F.pad(xm, (0, 0, D_CONV - 1, 0))[:, -(D_CONV - 1):]
    new_state = {"c": st_fin[0], "n": st_fin[1], "m": st_fin[2],
                 "conv": conv_tail}
    return matmul_rp(y, params["down"], cfg), new_state


def init_mlstm_state(cfg, batch, dtype, device="cuda"):
    dev = resolve_device(device)
    du, hd = mlstm_dims(cfg)
    h = cfg.n_heads
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "c": torch.zeros((batch, h, hd, hd), **f32),
        "n": torch.zeros((batch, h, hd), **f32),
        "m": torch.full((batch, h), NEG, **f32),
        "conv": torch.zeros((batch, D_CONV - 1, du), dtype=dtype,
                            device=dev),
    }


def _mlstm_step(q, k, v, logi, logf, c, n_in, m_in):
    """``mlstm_chunk_body`` at one token, with C updated in place.
    q, k, v: (B,H,hd) f32; logi/logf: (B,H).  Returns (h (B,H,hd), n, m).

    The chunk body's three-operand einsum would build (B,H,hd,hd)
    temporaries (16 MiB per lane and block at xlstm-1.3b's hd = 1024);
    here ``c`` is scaled and takes the rank-1 term in place.  h reads c
    before the update, as the chunk body reads c_in."""
    hd = q.shape[-1]
    scale = hd ** -0.5
    # the chunk body at q = 1: cumf = total = logf, and the decay
    # matrix's one entry is logi
    b_inter = logf + m_in
    m_comb = torch.maximum(logi, b_inter)
    d = torch.exp(logi - m_comb)
    inter_scale = torch.exp(b_inter - m_comb)
    s = (q * k).sum(-1) * scale * d                           # (B,H)
    cq = torch.einsum("bhde,bhe->bhd", c, q)
    num = s[..., None] * v + inter_scale[..., None] * cq * scale
    den = s + inter_scale * (n_in * q).sum(-1) * scale
    den = torch.maximum(den.abs(), torch.exp(-m_comb))
    ht = num / den[..., None]
    m_out = torch.maximum(m_in + logf, logi)
    wexp = torch.exp(logi - m_out)
    carry = torch.exp(m_in + logf - m_out)
    flat = c.view(-1, hd, hd)
    flat.mul_(carry.reshape(-1, 1, 1))
    flat.baddbmm_((wexp[..., None] * v).reshape(-1, hd, 1),
                  k.reshape(-1, 1, hd))
    n_out = carry[..., None] * n_in + wexp[..., None] * k
    return ht, n_out, m_out


def mlstm_decode(params, x, state, cfg):
    """One-token mLSTM step (the chunk body with q = 1).  x: (B,1,d).

    Returns (y, new state).  The new state's ``c`` is ``state["c"]``
    itself, updated in place; its other leaves are new tensors."""
    bs = x.shape[0]
    du, hd = mlstm_dims(cfg)
    h = cfg.n_heads
    xm = matmul(x[:, 0], params["up_x"])                   # (B,du)
    z = matmul(x[:, 0], params["up_z"])
    window = torch.cat([state["conv"], xm[:, None]], dim=1)
    xc = F.silu(torch.einsum("bkc,kc->bc", window.float(),
                             params["conv_w"].float())).to(x.dtype)
    q = torch.einsum("bhd,hde->bhe", _heads(xc, h, hd), params["wq"])
    k = torch.einsum("bhd,hde->bhe", _heads(xc, h, hd), params["wk"])
    v = torch.einsum("bhd,hde->bhe", _heads(xm, h, hd), params["wv"])
    logi, logf = _gates(params, xm)
    ht, n, m = _mlstm_step(q.float(), k.float(), v.float(), logi, logf,
                           state["c"], state["n"], state["m"])
    ht = ht.reshape(bs, du).to(x.dtype) + params["skip"] * xc
    y = rms_norm(params["norm_w"], ht, cfg.norm_eps) * F.silu(z)
    new_state = {"c": state["c"], "n": n, "m": m, "conv": window[:, 1:]}
    return matmul_rp(y, params["down"], cfg)[:, None], new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def init_slstm(gen, cfg, device="cuda"):
    dev = resolve_device(device)
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    dtype = cfg.torch_dtype()
    ffd = int(4 * d / 3)
    dense = lambda shape, **kw: dense_init(gen, shape, dtype, device=dev,
                                           **kw)
    return {
        "w": dense((d, 4 * d)),                            # i,f,z,o from x
        "r": dense((h, hd, 4 * hd), scale=hd ** -0.5),
        "bf": torch.full((d,), 3.0, dtype=torch.float32, device=dev),
        "norm_w": torch.ones((d,), dtype=dtype, device=dev),
        "ff_up": dense((d, 2 * ffd)),                      # GeGLU
        "ff_down": dense((ffd, d)),
    }


def init_slstm_state(cfg, batch, dtype, device="cuda"):
    """f32 whatever ``dtype`` (kept for the JAX signature)."""
    dev = resolve_device(device)
    d = cfg.d_model
    st = {k: torch.zeros((batch, d), dtype=torch.float32, device=dev)
          for k in ("c", "n", "h")}
    st["m"] = torch.full((batch, d), NEG, dtype=torch.float32, device=dev)
    return st


def _slstm_cell(params, gx, state, cfg, r32=None):
    """One sLSTM step.  gx: (B,4d) input-gate preactivations, laid out
    gate-major (i, f, z, o).  ``r32`` is ``params["r"]`` in f32 (a loop
    passes it in once).

    The recurrent term is laid out head-major ((B,h,4*hd) flattened) and
    added to gx as it is, before the split into i, f, z, o: the JAX
    package does so (``xlstm.py:265-269``), so with d = 4*hd gate i takes
    all of head 0's recurrent output, gate f head 1's, and so on."""
    if r32 is None:
        r32 = params["r"].float()
    h_heads = state["h"].reshape(gx.shape[0], cfg.n_heads, -1)
    gr = torch.einsum("bhd,hde->bhe", h_heads, r32)
    g = gx + gr.reshape(gx.shape[0], -1)                    # (B,4d)
    gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
    logf = torch.log(torch.sigmoid(gf + params["bf"]) + 1e-9)
    m_new = torch.maximum(logf + state["m"], gi)
    fi = torch.exp(logf + state["m"] - m_new)
    ii = torch.exp(gi - m_new)
    c = fi * state["c"] + ii * torch.tanh(gz)
    n = fi * state["n"] + ii
    hy = torch.sigmoid(go) * c / torch.clamp_min(n, 1e-6)
    return {"c": c, "n": n, "h": hy, "m": m_new}


def _geglu_out(params, y):
    """GeGLU feed-forward; ``jax.nn.gelu``'s default is the tanh form."""
    up, gate = torch.chunk(matmul(y, params["ff_up"]), 2, dim=-1)
    return matmul(F.gelu(up, approximate="tanh") * gate, params["ff_down"])


def slstm_forward(params, x, cfg, state=None) -> Tuple[torch.Tensor, dict]:
    """Sequential sLSTM over the sequence. x: (B,L,d)."""
    bs, length, _ = x.shape
    gx = matmul(x, params["w"]).float()                     # (B,L,4d)
    st = state or init_slstm_state(cfg, bs, x.dtype, device=x.device)
    r32 = params["r"].float()
    hs = []
    for t in range(length):
        st = _slstm_cell(params, gx[:, t], st, cfg, r32)
        hs.append(st["h"])
    y = torch.stack(hs, dim=1).to(x.dtype)                  # (B,L,d)
    y = rms_norm(params["norm_w"], y, cfg.norm_eps)
    return _geglu_out(params, y), st


def slstm_decode(params, x, state, cfg):
    gx = matmul(x[:, 0], params["w"]).float()
    st = _slstm_cell(params, gx, state, cfg)
    y = rms_norm(params["norm_w"], st["h"].to(x.dtype), cfg.norm_eps)
    return _geglu_out(params, y)[:, None], st
