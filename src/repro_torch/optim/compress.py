"""Gradient/delta compression with error feedback (PyTorch port of
``repro.optim.compress``).

Each gradient leaf is chunked and each chunk ships only its
largest-magnitude element (merge op = sum): the threshold-select codec of
``kernels.collective_codec``, one O(n) streaming pass.  The message is a
fixed ``frac`` of the leaf; the residual is kept locally and added to the
next step's gradient (error feedback).

``compress`` returns (values, indices) per leaf, the analogue of the
paper's (offset, bytes) diff list, plus the new residual; ``decompress``
scatters back to dense f32 leaves for the merge.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.collective_codec import ops as codec_ops
from repro_torch.weights import tree_leaves, tree_map, tree_unflatten


def _select_leaf(g: torch.Tensor, frac: float):
    sel, idx, resid = codec_ops.select_codec(g.reshape(-1), frac=frac)
    return (sel, idx), resid.reshape(g.shape)


def compress(grads, residual, frac: float = 0.05):
    """grads (+ carried residual) -> (sparse diff tree, new residual).
    A sparse leaf is the tuple (vals (k,), idx (k,) int32)."""
    if residual is not None:
        flat = [g.float() + r for g, r in zip(tree_leaves(grads),
                                              tree_leaves(residual))]
    else:
        flat = [g.float() for g in tree_leaves(grads)]
    out = [_select_leaf(g, frac) for g in flat]
    sparse = tree_unflatten(grads, [o[0] for o in out])
    resid = tree_unflatten(grads, [o[1] for o in out])
    return sparse, resid


def decompress(sparse, shapes_like):
    """Scatter sparse (vals, idx) diffs back to dense f32 leaves of the
    given shapes (the paper's merge-apply with op=sum onto a zero base)."""
    likes = tree_leaves(shapes_like)
    pairs = _sparse_leaves(sparse)
    dense = [torch.zeros(like.numel(), dtype=torch.float32,
                         device=vals.device).index_add_(0, idx.long(), vals)
             .reshape(like.shape)
             for (vals, idx), like in zip(pairs, likes)]
    return tree_unflatten(shapes_like, dense)


def _sparse_leaves(sparse) -> list:
    """The (vals, idx) pairs of a sparse tree, in tree order."""
    if isinstance(sparse, tuple) and len(sparse) == 2 \
            and all(isinstance(t, torch.Tensor) for t in sparse):
        return [sparse]
    if isinstance(sparse, dict):
        return [p for k in sorted(sparse) for p in _sparse_leaves(sparse[k])]
    if isinstance(sparse, (list, tuple)):
        return [p for v in sparse for p in _sparse_leaves(v)]
    return []


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compression_ratio(sparse, dense_like) -> float:
    sent = sum(v.numel() + i.numel() for v, i in _sparse_leaves(sparse))
    total = sum(leaf.numel() for leaf in tree_leaves(dense_like))
    return sent / max(total, 1)
