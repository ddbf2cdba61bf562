"""Model API of the serving path (PyTorch port of ``repro.models.model``):
prefill and serve steps, parameter counting and the decode window.  The
train-side functions (loss, train step) come with the training slice.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import transformer as tf
from repro_torch.weights import tree_leaves

# zamba2's shared attention block uses this sliding window for the
# long_500k shape (sub-quadratic adaptation, DESIGN.md §4).
LONG_CONTEXT_WINDOW = 4096


@functools.lru_cache(maxsize=64)
def count_params(cfg: ArchConfig) -> int:
    """Exact parameter count, from the init's shapes on the meta device."""
    params = tf.init_params(None, cfg, device="meta")
    return int(sum(t.numel() for t in tree_leaves(params)))


def _ctx_from_batch(cfg, batch, **extra):
    ctx = dict(extra)
    if cfg.family == "audio":
        ctx["frames"] = batch["frames"]
    if cfg.family == "vlm":
        ctx["img"] = batch["img"]
    return ctx


def make_prefill_step(cfg: ArchConfig, window: int = 0) -> Callable:
    """(params, batch) -> (last_logits (B,1,V) f32, decode states).

    Unembeds ONLY the last position: the (B, S, V) logits of a long
    prefill would otherwise dominate device memory."""
    def prefill_step(params, batch):
        ctx = _ctx_from_batch(cfg, batch, collect_state=True, window=window,
                              return_hidden=True)
        hidden, _, states = tf.forward(params, batch["tokens"], cfg, ctx)
        head = tf._head(params, cfg)
        logits = torch.matmul(hidden[:, -1:].float(), head.float())
        return logits, states
    return prefill_step


def make_serve_step(cfg: ArchConfig, window: int = 0) -> Callable:
    """(params, states, tokens (B,1), positions (B,1)) ->
    (logits (B,1,V), states updated in place)."""
    def serve_step(params, states, tokens, positions):
        return tf.decode_step(params, tokens, states, positions, cfg,
                              {"window": window})
    return serve_step


def decode_window(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """Sliding window used by attention blocks for this (arch, shape)."""
    if shape.name == "long_500k" and cfg.family == "hybrid":
        return LONG_CONTEXT_WINDOW
    return cfg.window if shape.name == "long_500k" else 0
