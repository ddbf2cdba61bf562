"""Model API (PyTorch port of ``repro.models.model``): the train state,
loss, gradient and train step; prefill and serve steps; parameter
counting and the decode window; the shape specs of every (arch x shape)
cell; and ``build(cfg)``, one object carrying all of it.

A spec is a tensor on the meta device (the port's ``jax.ShapeDtypeStruct``):
its shape and dtype, no data.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import fused_unembed_xent, matmul_f32out
from repro_torch.models.shardings import spec_leaves
from repro_torch.optim import adamw
from repro_torch.weights import (tree_leaves, tree_leaves_with_path,
                                 tree_map, tree_unflatten)

# zamba2's shared attention block uses this sliding window for the
# long_500k shape (sub-quadratic adaptation, DESIGN.md §4).
LONG_CONTEXT_WINDOW = 4096


@functools.lru_cache(maxsize=64)
def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Exact parameter count, from the init's shapes on the meta device.
    With ``active_only`` an MoE's expert weights count ``top_k`` of their
    ``n_experts`` (the parameters one token runs through)."""
    params = tf.init_params(None, cfg, device="meta")
    total = 0
    for path, leaf in tree_leaves_with_path(params):
        n = leaf.numel()
        if active_only and cfg.n_experts and "['moe']" in path \
                and path.endswith(("['w1']", "['w2']", "['w3']")):
            n = n * cfg.top_k // cfg.n_experts
        total += n
    return int(total)


def _ctx_from_batch(cfg, batch, **extra):
    ctx = dict(extra)
    if cfg.family == "audio":
        ctx["frames"] = batch["frames"]
    if cfg.family == "vlm":
        ctx["img"] = batch["img"]
    return ctx


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------
def init_train_state(gen, cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                     device="cuda"):
    params = tf.init_params(gen, cfg, device=device)
    return {"params": params, "opt": adamw.init(params)}


def make_loss_fn(cfg: ArchConfig) -> Callable:
    """(params, batch) -> (loss, {"loss", "xent", "aux_loss"}).  One loss
    function covers the JAX package's ``deploy`` and default modes (see
    ``layers.fused_unembed_xent``)."""
    def loss_fn(params, batch):
        ctx = _ctx_from_batch(cfg, batch, return_hidden=True)
        hidden, aux, _ = tf.forward(params, batch["tokens"], cfg, ctx)
        xent = fused_unembed_xent(hidden, tf._head(params, cfg),
                                  batch["labels"])
        loss = xent + aux
        return loss, {"loss": loss, "xent": xent, "aux_loss": aux}
    return loss_fn


def _grad_leaves(params):
    """(tree for the forward pass, its leaves that take gradients).

    Each stacked block leaf is split into per-period views, so autograd
    hands back one gradient per period instead of scattering every
    period's gradient into a zero tensor of the whole stack."""
    def leaf(t):
        return t.detach().requires_grad_()
    blocks = [None if stacked is None else
              [tree_map(lambda a, i=i: leaf(a[i]), stacked)
               for i in range(tree_leaves(stacked)[0].shape[0])]
              for stacked in params["blocks"]]
    tree = {k: (blocks if k == "blocks" else tree_map(leaf, v))
            for k, v in params.items()}
    return tree, tree_leaves(tree)


def make_grad_fn(cfg: ArchConfig) -> Callable:
    """(params, batch) -> ((loss, metrics), grads): the port's
    ``jax.value_and_grad(loss_fn, has_aux=True)``.  ``grads`` has the
    params' structure and dtypes; metrics are detached."""
    loss_fn = make_loss_fn(cfg)

    def grad_fn(params, batch):
        with torch.enable_grad():
            tree, leaves = _grad_leaves(params)
            loss, metrics = loss_fn(tree, batch)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        flat = [torch.zeros_like(x) if g is None else g
                for x, g in zip(leaves, flat)]
        per_period = tree_unflatten(tree, flat)
        grads = {k: v for k, v in per_period.items() if k != "blocks"}
        grads["blocks"] = [
            None if periods is None else
            tree_unflatten(periods[0], [
                torch.stack(xs) for xs in
                zip(*(tree_leaves(p) for p in periods))])
            for periods in per_period["blocks"]]
        grads = {k: grads[k] for k in params}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), grads
    return grad_fn


def _check_pspecs(what: str, tree, pspecs) -> None:
    """Raise unless ``pspecs`` has one spec per tensor leaf of ``tree``,
    each as long as its leaf's rank (``models.shardings``)."""
    leaves = [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    specs = spec_leaves(pspecs)
    if len(specs) != len(leaves):
        raise ValueError(f"{what}: {len(specs)} specs for {len(leaves)} "
                         "leaves")
    for t, spec in zip(leaves, specs):
        if len(spec) != t.dim():
            raise ValueError(f"{what}: spec {spec} for a leaf of shape "
                             f"{tuple(t.shape)}")


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    grad_accum: int = 1, grad_pspecs=None,
                    batch_pspecs=None) -> Callable:
    """(state, batch) -> (state, metrics).

    ``grad_accum`` splits the batch into that many microbatches and
    accumulates their gradients in f32 (the JAX package's unrolled loop;
    its ``deploy`` scan is the same sum).  The optimizer updates the
    state's tensors in place (``optim.adamw``).  ``grad_pspecs`` and
    ``batch_pspecs`` (``models.shardings``) pin the gradients' and the
    batch's shardings in the JAX package; on one card they move no data
    and are only held against the gradients' and the batch's ranks."""
    grad_fn = make_grad_fn(cfg)

    def train_step(state, batch):
        params = state["params"]
        if batch_pspecs is not None:
            _check_pspecs("batch_pspecs", batch, batch_pspecs)
        if grad_accum == 1:
            (_, metrics), grads = grad_fn(params, batch)
        else:
            b = batch["tokens"].shape[0]
            mb = b // grad_accum
            grads = metrics = None
            for i in range(grad_accum):
                sl = {k: x[i * mb:(i + 1) * mb] for k, x in batch.items()}
                (_, m), g = grad_fn(params, sl)
                g = tree_map(lambda a: a.float(), g)
                grads = g if grads is None else tree_unflatten(g, [
                    a + b_ for a, b_ in zip(tree_leaves(grads),
                                            tree_leaves(g))])
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in metrics}
            grads = tree_map(lambda a: a / grad_accum, grads)
            metrics = {k: v / grad_accum for k, v in metrics.items()}
        if grad_pspecs is not None:
            _check_pspecs("grad_pspecs", grads, grad_pspecs)
        params, opt, om = adamw.apply(grads, state["opt"], params, opt_cfg)
        return {"params": params, "opt": opt}, {**metrics, **om}
    return train_step


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ArchConfig, window: int = 0) -> Callable:
    """(params, batch) -> (last_logits (B,1,V) f32, decode states).

    Unembeds ONLY the last position: the (B, S, V) logits of a long
    prefill would otherwise dominate device memory.  The product is
    ``matmul_f32out``: f32 logits without an f32 copy of the head.  With
    a window, each attention state is the prompt's last ``window`` K/V
    rows (all a ring can hold): a 500k-token prompt's whole K/V would
    not fit the card beside its activations."""
    def prefill_step(params, batch):
        ctx = _ctx_from_batch(cfg, batch, collect_state=True, window=window,
                              return_hidden=True, kv_rows=window)
        hidden, _, states = tf.forward(params, batch["tokens"], cfg, ctx)
        logits = matmul_f32out(hidden[:, -1:], tf._head(params, cfg))
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


# ---------------------------------------------------------------------------
# Shape specs for every (arch x shape) cell: tensors on the meta device
# ---------------------------------------------------------------------------
def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                with_labels: bool = True) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _spec((b, s), torch.int32)}
    if with_labels:
        specs["labels"] = _spec((b, s), torch.int32)
    if cfg.family == "audio":
        specs["frames"] = _spec((b, cfg.enc_seq, cfg.d_model),
                                cfg.torch_dtype())
    if cfg.family == "vlm":
        specs["img"] = _spec((b, cfg.n_img_tokens, cfg.d_model),
                             cfg.torch_dtype())
    return specs


def train_state_specs(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig):
    """The train state's specs; its step is the port's host int (0), where
    the JAX package's is a () int32 array."""
    return init_train_state(None, cfg, opt_cfg, device="meta")


def param_specs(cfg: ArchConfig):
    return tf.init_params(None, cfg, device="meta")


def decode_state_specs(cfg: ArchConfig, shape: ShapeConfig):
    return tf.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                cfg.torch_dtype(),
                                window=decode_window(cfg, shape),
                                device="meta")


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig):
    b = shape.global_batch
    return {"tokens": _spec((b, 1), torch.int32),
            "positions": _spec((b, 1), torch.int32)}


# ---------------------------------------------------------------------------
# build(): one object carrying everything the launcher needs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    init_params: Callable
    init_train_state: Callable
    loss_fn: Callable
    make_train_step: Callable
    make_prefill_step: Callable
    make_serve_step: Callable


def build(cfg: ArchConfig) -> ModelAPI:
    return ModelAPI(
        cfg=cfg,
        init_params=functools.partial(tf.init_params, cfg=cfg),
        init_train_state=functools.partial(init_train_state, cfg=cfg),
        loss_fn=make_loss_fn(cfg),
        make_train_step=functools.partial(make_train_step, cfg),
        make_prefill_step=functools.partial(make_prefill_step, cfg),
        make_serve_step=functools.partial(make_serve_step, cfg),
    )
