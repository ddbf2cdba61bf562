"""Block stack of every family: dense, MoE, hybrid, xLSTM, VLM and audio
(PyTorch port of ``repro.models.transformer``).

The stack is ``n_periods`` repetitions of a period of block kinds (see
``ArchConfig.period()``); parameters and decode states are stacked per
period position with a leading ``n_per`` axis, as in the JAX package, and
the periods run as a Python loop over that axis.  zamba2's shared
attention block lives unstacked in ``params["shared"]``, with ``None`` at
its place in ``params["blocks"]``; it keeps a KV state per period like any
attention block.

The VLM's CROSS_ATTN block attends to the image embeddings
(``ctx["img"]``) through tanh gates (f32 scalars, 0 at init, so a freshly
initialised block is the identity); its decode state is the image K/V.
The audio family's ENCDEC block adds cross-attention to the encoder's
states (``ctx["enc"]``, which ``forward`` computes from ``ctx["frames"]``
with ``encode``) after a causal self-attention; its decode state is the
self-attention cache plus the encoder K/V (``xk``, ``xv``).
Cross-attention and the bidirectional encoder are plain products, as in
the JAX package (its kernel takes only causal self-attention); the
causal self-attentions run the flash kernel on CUDA.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs import base as cb
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (dense_init, init_mlp, matmul, mlp,
                                       rms_norm)
from repro_torch.weights import tree_map


_ATTN_KINDS = (cb.ATTN, cb.SHARED_ATTN, cb.MOE)
# recurrent kinds: (params key, full-sequence forward, one-token decode)
_RECURRENT = {
    cb.MAMBA: ("mamba", ssm_mod.mamba_forward, ssm_mod.mamba_decode),
    cb.MLSTM: ("mlstm", xlstm_mod.mlstm_forward, xlstm_mod.mlstm_decode),
    cb.SLSTM: ("slstm", xlstm_mod.slstm_forward, xlstm_mod.slstm_decode),
}


# ---------------------------------------------------------------------------
# Per-kind block init
# ---------------------------------------------------------------------------
def init_block(gen, kind: str, cfg, device="cuda") -> Dict[str, Any]:
    dtype = cfg.torch_dtype()
    dev = resolve_device(device)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    if kind in (cb.ATTN, cb.SHARED_ATTN):
        return {"ln1": ones(),
                "attn": attn.init_attention(gen, cfg, device=dev),
                "ln2": ones(),
                "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                                device=dev)}
    if kind == cb.MOE:
        return {"ln1": ones(),
                "attn": attn.init_attention(gen, cfg, device=dev),
                "ln2": ones(), "moe": moe_mod.init_moe(gen, cfg, device=dev)}
    if kind == cb.CROSS_ATTN:
        # llama3.2-vision style: tanh-gated cross-attention + gated MLP
        gate = lambda: torch.zeros((), dtype=torch.float32, device=dev)
        return {"ln1": ones(),
                "xattn": attn.init_attention(gen, cfg, device=dev),
                "ln2": ones(),
                "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                                device=dev),
                "gate_attn": gate(), "gate_mlp": gate()}
    if kind == cb.ENCDEC:
        return {"ln1": ones(),
                "attn": attn.init_attention(gen, cfg, device=dev),
                "lnx": ones(),
                "xattn": attn.init_attention(gen, cfg, device=dev),
                "ln2": ones(),
                "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                                device=dev)}
    if kind == cb.MAMBA:
        return {"ln1": ones(),
                "mamba": ssm_mod.init_mamba(gen, cfg, device=dev)}
    if kind == cb.MLSTM:
        return {"ln1": ones(),
                "mlstm": xlstm_mod.init_mlstm(gen, cfg, device=dev)}
    if kind == cb.SLSTM:
        return {"ln1": ones(),
                "slstm": xlstm_mod.init_slstm(gen, cfg, device=dev)}
    raise ValueError(kind)


def init_block_state(kind: str, cfg, batch: int, max_len: int, dtype,
                     window: int = 0, device="cuda"):
    """Decode-time state for one block (unstacked)."""
    if kind in _ATTN_KINDS:
        return attn.init_kv_cache(cfg, batch, max_len, dtype, window=window,
                                  device=device)
    if kind in (cb.CROSS_ATTN, cb.ENCDEC):
        dev = resolve_device(device)
        seq = cfg.n_img_tokens if kind == cb.CROSS_ATTN else cfg.enc_seq
        shape = (batch, seq, cfg.n_kv_heads, cfg.hd())
        cross = [torch.zeros(shape, dtype=dtype, device=dev)
                 for _ in range(2)]
        if kind == cb.CROSS_ATTN:
            return dict(zip(("k", "v"), cross))
        c = attn.init_kv_cache(cfg, batch, max_len, dtype, device=dev)
        c["xk"], c["xv"] = cross
        return c
    if kind == cb.MAMBA:
        return ssm_mod.init_mamba_state(cfg, batch, dtype, device=device)
    if kind == cb.MLSTM:
        return xlstm_mod.init_mlstm_state(cfg, batch, dtype, device=device)
    if kind == cb.SLSTM:
        return xlstm_mod.init_slstm_state(cfg, batch, dtype, device=device)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Per-kind block apply
# ---------------------------------------------------------------------------
def _gate(g, x):
    """A CROSS_ATTN gate: tanh of the f32 scalar, cast to x's dtype (the
    JAX package's ``jnp.tanh(g).astype(x.dtype)``)."""
    return torch.tanh(g).to(x.dtype)


def _gated_mlp(p, x, cfg):
    """The CROSS_ATTN block's second half: x + tanh(gate_mlp) * MLP."""
    h = mlp(p["mlp"], rms_norm(p["ln2"], x, cfg.norm_eps), cfg.act, cfg)
    return x + _gate(p["gate_mlp"], x) * h


def apply_block_seq(kind: str, p, x, cfg, ctx):
    """x: (B,S,d) -> (x', aux_loss, state).

    ``state`` is the decode-time handover (KV cache or SSM state) when
    ``ctx["collect_state"]`` is set; otherwise None.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    collect = ctx.get("collect_state", False)
    if kind in _ATTN_KINDS:
        h, (k, v) = attn.attention(
            p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps), cfg,
            ctx["positions"], causal=True, window=ctx.get("window", 0))
        state = {"k": k, "v": v} if collect else None
        x = x + h
        if kind == cb.MOE:
            h, aux = moe_mod.moe_ffn(p["moe"],
                                     rms_norm(p["ln2"], x, cfg.norm_eps), cfg)
        else:
            h = mlp(p["mlp"], rms_norm(p["ln2"], x, cfg.norm_eps), cfg.act,
                    cfg)
        return x + h, aux, state
    if kind == cb.CROSS_ATTN:
        h, (k, v) = attn.attention(
            p["xattn"], rms_norm(p["ln1"], x, cfg.norm_eps), cfg,
            ctx["positions"], causal=False, kv_x=ctx["img"], use_rope=False)
        state = {"k": k, "v": v} if collect else None
        return _gated_mlp(p, x + _gate(p["gate_attn"], x) * h, cfg), aux, \
            state
    if kind == cb.ENCDEC:
        h, (k, v) = attn.attention(
            p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps), cfg,
            ctx["positions"], causal=True)
        x = x + h
        h, (xk, xv) = attn.attention(
            p["xattn"], rms_norm(p["lnx"], x, cfg.norm_eps), cfg,
            ctx["positions"], causal=False, kv_x=ctx["enc"], use_rope=False)
        state = ({"k": k, "v": v, "xk": xk, "xv": xv} if collect
                 else None)
        x = x + h
        h = mlp(p["mlp"], rms_norm(p["ln2"], x, cfg.norm_eps), cfg.act, cfg)
        return x + h, aux, state
    if kind in _RECURRENT:
        key, fwd, _ = _RECURRENT[kind]
        h, st = fwd(p[key], rms_norm(p["ln1"], x, cfg.norm_eps), cfg)
        return x + h, aux, (st if collect else None)
    raise ValueError(kind)


def apply_block_decode(kind: str, p, x, state, cfg, ctx):
    """x: (B,1,d) -> (x', state); ``state`` (a KV cache or a recurrent
    state) is updated in place and returned: each new leaf is copied into
    the old one, unless the block updated that leaf in place itself (the
    mLSTM's matrix memory)."""
    if kind in _ATTN_KINDS:
        h, state = attn.decode_attention(
            p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps), state, cfg,
            ctx["positions"], window=ctx.get("window", 0))
        x = x + h
        if kind == cb.MOE:
            h, _ = moe_mod.moe_ffn(p["moe"],
                                   rms_norm(p["ln2"], x, cfg.norm_eps), cfg)
        else:
            h = mlp(p["mlp"], rms_norm(p["ln2"], x, cfg.norm_eps), cfg.act,
                    cfg)
        return x + h, state
    if kind == cb.CROSS_ATTN:
        # the image K/V of the state are static: read, never written
        h, _ = attn.decode_attention(
            p["xattn"], rms_norm(p["ln1"], x, cfg.norm_eps), state, cfg,
            ctx["positions"], kv_x=True, use_rope=False)
        return _gated_mlp(p, x + _gate(p["gate_attn"], x) * h, cfg), state
    if kind == cb.ENCDEC:
        # the new self-attention row goes into state["k"] / state["v"]
        # in place; the encoder K/V (xk, xv) are only read
        h, _ = attn.decode_attention(
            p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps), state, cfg,
            ctx["positions"])
        x = x + h
        h, _ = attn.decode_attention(
            p["xattn"], rms_norm(p["lnx"], x, cfg.norm_eps),
            {"k": state["xk"], "v": state["xv"]}, cfg, ctx["positions"],
            kv_x=True, use_rope=False)
        x = x + h
        h = mlp(p["mlp"], rms_norm(p["ln2"], x, cfg.norm_eps), cfg.act, cfg)
        return x + h, state
    if kind in _RECURRENT:
        key, _, dec = _RECURRENT[kind]
        h, new = dec(p[key], rms_norm(p["ln1"], x, cfg.norm_eps), state, cfg)
        for name, t in new.items():
            if t is not state[name]:
                state[name].copy_(t)
        return x + h, state
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------
def _stack(trees):
    """Stack a list of identically-shaped dict trees along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def init_params(gen: Optional[torch.Generator], cfg,
                device="cuda") -> Dict[str, Any]:
    """Random parameters drawn from ``gen`` (on its device, then moved to
    ``device``).  ``device="meta"`` builds shapes only, with no generator."""
    dev = resolve_device(device)
    dtype = cfg.torch_dtype()
    period = cfg.period()
    n_per = cfg.n_periods()
    params: Dict[str, Any] = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), dtype, scale=0.02,
                            device=dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dtype,
                                       device=dev)
    # the shared block's weights live in params["shared"], unstacked
    params["blocks"] = [
        None if kind == cb.SHARED_ATTN else
        _stack([init_block(gen, kind, cfg, device=dev) for _ in range(n_per)])
        for kind in period]
    if cb.SHARED_ATTN in period:
        params["shared"] = init_block(gen, cb.SHARED_ATTN, cfg, device=dev)
    if cfg.family == "audio":
        params["encoder"] = {
            "blocks": _stack([init_block(gen, cb.ATTN, cfg, device=dev)
                              for _ in range(cfg.n_enc_layers)]),
            "norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev)}
    return params


# ---------------------------------------------------------------------------
# Encoder (audio): bidirectional attention over pre-embedded frames
# ---------------------------------------------------------------------------
def _sinusoid(seq: int, d: int, device) -> torch.Tensor:
    """(seq, d) f32 sinusoidal positions: sin on even columns, cos on odd
    ones, each step in f32 as the JAX package computes it."""
    f32 = torch.float32
    pos = torch.arange(seq, dtype=f32, device=device)[:, None]
    log = torch.log(torch.tensor(10000.0, dtype=f32, device=device))
    div = torch.exp(-log * torch.arange(0, d, 2, dtype=f32, device=device)
                    / d)
    pe = torch.zeros((seq, d), dtype=f32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def encode(params, frames, cfg):
    """frames: (B, enc_seq, d) stub frontend output -> encoder states.
    The positions are added in f32 cast to the frames' dtype; each of
    the ``n_enc_layers`` blocks is bidirectional self-attention (no RoPE)
    and an MLP; a final RMSNorm."""
    seq = frames.shape[1]
    x = frames + _sinusoid(seq, cfg.d_model, frames.device).to(frames.dtype)
    enc = params["encoder"]
    positions = torch.arange(seq, device=frames.device)[None, :]
    for i in range(cfg.n_enc_layers):
        p = period_params(enc["blocks"], i)
        h, _ = attn.attention(p["attn"],
                              rms_norm(p["ln1"], x, cfg.norm_eps), cfg,
                              positions, causal=False, use_rope=False)
        x = x + h
        x = x + mlp(p["mlp"], rms_norm(p["ln2"], x, cfg.norm_eps), cfg.act,
                    cfg)
    return rms_norm(enc["norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------
def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def period_params(stacked, i: int):
    """Period ``i``'s parameters of one period position: a slice of the
    stacked tree, or entry ``i`` where the caller split the stack into a
    list of per-period trees (``model.make_grad_fn`` does, so that each
    period's gradient is its own tensor rather than a scatter into the
    whole stack)."""
    if isinstance(stacked, list):
        return stacked[i]
    return tree_map(lambda a: a[i], stacked)


def _period_ps(params, period, i: int):
    """Every block's parameters of period ``i``: the shared block's own
    where the period says SHARED_ATTN."""
    return [params["shared"] if kind == cb.SHARED_ATTN
            else period_params(stacked, i)
            for kind, stacked in zip(period, params["blocks"])]


def _period_body(x, aux, ps, period, cfg, ctx):
    states = []
    for kind, p in zip(period, ps):
        x, a, st = apply_block_seq(kind, p, x, cfg, ctx)
        aux = aux + a
        states.append(st)
    return x, aux, states


def forward(params, tokens, cfg, ctx: Optional[Dict[str, Any]] = None):
    """tokens: (B,S) integer -> (logits (B,S,V), aux_loss, states).

    ``states`` is a list of stacked per-period-position decode states when
    ``ctx["collect_state"]`` (prefill), else None.  With
    ``ctx["return_hidden"]`` the final-norm hidden states come back in
    place of the logits.  With ``cfg.remat`` and gradients on, each period
    runs under ``torch.utils.checkpoint`` (the JAX package's
    ``jax.checkpoint`` of the period body): its activations are recomputed
    in the backward pass instead of being kept.
    """
    ctx = dict(ctx or {})
    s = tokens.shape[1]
    x = F.embedding(tokens.long(), params["embed"])
    ctx.setdefault("positions",
                   torch.arange(s, device=tokens.device)[None, :])
    if cfg.family == "audio":
        ctx["enc"] = encode(params, ctx["frames"], cfg)
    collect = ctx.get("collect_state", False)
    remat = cfg.remat and not collect and torch.is_grad_enabled()
    period = cfg.period()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_period = []
    for i in range(cfg.n_periods()):
        ps = _period_ps(params, period, i)
        if remat:
            x, aux, states = checkpoint(_period_body, x, aux, ps, period,
                                        cfg, ctx, use_reentrant=False)
        else:
            x, aux, states = _period_body(x, aux, ps, period, cfg, ctx)
        per_period.append(states)
    states = ([_stack([pp[j] for pp in per_period])
               for j in range(len(period))] if collect else None)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    if ctx.get("return_hidden"):
        return x, aux, states
    return matmul(x, _head(params, cfg)), aux, states


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------
def init_decode_state(cfg, batch: int, max_len: int, dtype, window: int = 0,
                      device="cuda"):
    """Stacked per-period-position decode state (tree of (n_per, ...))."""
    n_per = cfg.n_periods()
    states = []
    for kind in cfg.period():
        one = init_block_state(kind, cfg, batch, max_len, dtype,
                               window=window, device=device)
        states.append(tree_map(
            lambda a: a[None].repeat(n_per, *([1] * a.ndim)), one))
    return states


def decode_step(params, tokens, states, positions, cfg,
                ctx: Optional[Dict[str, Any]] = None):
    """One-token decode. tokens: (B,1); positions: (B,1) absolute.

    states: output of ``init_decode_state`` (possibly filled by prefill);
    updated in place.  Returns (logits (B,1,V), states).
    """
    ctx = dict(ctx or {})
    ctx["positions"] = positions
    x = F.embedding(tokens.long(), params["embed"])
    period = cfg.period()
    for i in range(cfg.n_periods()):
        for kind, p, st in zip(period, _period_ps(params, period, i),
                               states):
            x, _ = apply_block_decode(kind, p, x,
                                      tree_map(lambda a: a[i], st), cfg, ctx)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return matmul(x, _head(params, cfg)), states
