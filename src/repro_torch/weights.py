"""Parameters across the package boundary: numpy pytrees <-> torch dicts.

The JAX package's params are nested dicts/lists of arrays; handed over as
numpy (``jax.tree.map(np.asarray, params)``) they become the port's dict of
tensors with the same keys and the same stacked layout (``embed``,
``final_norm``, ``blocks[i][...]`` with the leading ``n_per`` axis).
bfloat16 arrays cross as raw 16-bit words, so no value is rounded.
Train states (``{"params", "opt": {"m", "v", "step"}}``) cross with
``state_from_numpy`` / ``state_to_numpy``.

Leaf order is ``jax.tree.flatten``'s: dict keys sorted, lists and tuples
in order, None an empty subtree.  Whatever flattens a tree into one
vector (the gradient sync, the optimizer's global norm) walks it in this
order, so its layout is the JAX package's.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device


def _leaf_to_torch(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Convert a pytree of numpy arrays (dicts, lists, tuples, None) into
    the same structure of tensors on ``device``."""
    dev = resolve_device(device)

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return _leaf_to_torch(x, dev)
    return conv(tree)


def params_to_numpy(tree: Any, bf16_dtype: Optional[np.dtype] = None) -> Any:
    """The reverse of ``params_from_numpy``.  bfloat16 tensors come back
    as their raw 16-bit words viewed as ``bf16_dtype`` (the caller's numpy
    bfloat16 type); without one they stay ``uint16`` words."""
    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            words = t.view(torch.int16).numpy().view(np.uint16)
            return words.view(bf16_dtype) if bf16_dtype is not None \
                else words
        return t.numpy()
    return conv(tree)


def tree_map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf of a dict/list/tuple tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """Tensor leaves of a dict/list/tuple tree in ``jax.tree.flatten``
    order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_leaves_with_path(tree: Any, prefix: str = "") -> list:
    """``(path, leaf)`` pairs in ``tree_leaves`` order; a path is the
    string ``jax.tree_util.keystr`` gives the same leaf of the JAX tree
    (``"['opt']['m']['embed']"``, ``"['params']['blocks'][0]['wq']"``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in
                tree_leaves_with_path(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree) for pair in
                tree_leaves_with_path(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree of ``like``'s structure whose leaves, in ``tree_leaves``
    order, are ``leaves`` (the inverse of ``tree_leaves``)."""
    it = iter(leaves)

    def build(x):
        if x is None:
            return None
        if isinstance(x, dict):
            built = {k: build(x[k]) for k in sorted(x)}
            return {k: built[k] for k in x}     # keep the key order
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def state_from_numpy(state: Any, device="cuda") -> dict:
    """A JAX train state as numpy (``jax.tree.map(np.asarray, state)``)
    -> the port's: the same params and f32 moments as tensors, the step
    count as an int."""
    opt = state["opt"]
    return {"params": params_from_numpy(state["params"], device),
            "opt": {"m": params_from_numpy(opt["m"], device),
                    "v": params_from_numpy(opt["v"], device),
                    "step": int(np.asarray(opt["step"]))}}


def state_to_numpy(state: Any, bf16_dtype: Optional[np.dtype] = None) -> dict:
    """The reverse of ``state_from_numpy``; the step is an int32 scalar as
    in the JAX package."""
    opt = state["opt"]
    return {"params": params_to_numpy(state["params"], bf16_dtype),
            "opt": {"m": params_to_numpy(opt["m"]),
                    "v": params_to_numpy(opt["v"]),
                    "step": np.asarray(opt["step"], dtype=np.int32)}}
