"""AdamW over parameter trees, with a cosine LR schedule and global-norm
clipping (PyTorch port of ``repro.optim.adamw``).

The moments (m, v) are f32 whatever the parameters' dtype and the step
count is an int; the update is computed in f32 and cast back to each
parameter's dtype (no master weights, as in the JAX package).  Order:
clip, then the LR, then bias correction, then decoupled decay on leaves
with ndim >= 2.  ``init(params) -> state``;
``apply(grads, state, params, cfg) -> (params, state, metrics)``.

Unlike the JAX package's pure update, ``apply`` writes the new moments
and parameters into the tensors it was given (one leaf at a time), which
keeps a full-width step from holding a second copy of the parameters and
moments; the returned trees are those same tensors.  Scalars (LR, bias
corrections) are computed in f32 tensors, as the JAX package's traced
arithmetic does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.weights import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def cosine_lr(cfg: AdamWConfig, step, device="cpu") -> torch.Tensor:
    """The LR at ``step`` (int or tensor), as an f32 scalar tensor."""
    step = torch.as_tensor(step, device=device).to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi, device) * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's f32 sum
    of squares."""
    total = None
    for leaf in tree_leaves(tree):
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads as f32 scaled to at most ``max_norm`` in global norm,
    the norm before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def init(params) -> Dict[str, Any]:
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "step": 0}


@torch.no_grad()
def apply(grads, state, params, cfg: AdamWConfig
          ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step; returns (params, state, {"grad_norm", "lr"}).  The
    parameters and moments are updated in place (module docstring)."""
    device = tree_leaves(params)[0].device
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    lr = cosine_lr(cfg, step, device)
    t = _f32(step, device)
    bc1 = 1 - _f32(cfg.b1, device) ** t
    bc2 = 1 - _f32(cfg.b2, device) ** t
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        del g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = p.float()
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.dim() >= 2:
            upd.add_(cfg.weight_decay * p32)
        p.copy_(p32 - lr * upd)
    state = {"m": state["m"], "v": state["v"], "step": step}
    return params, state, {"grad_norm": gnorm, "lr": lr}
