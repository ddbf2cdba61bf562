"""Locality-aware gradient sync over a gang of virtual ranks (PyTorch port
of the schedules of ``repro.core.collectives``).

The JAX package runs each schedule as a ``shard_map`` body over a
(pod, data) device mesh: the pod is the paper's VM (slow links between
pods), the data axis its fast in-memory queues.  The port's gang lives on
one device as ``pods × data`` virtual ranks (rank ``r`` is pod
``r // data``, data index ``r % data``, as the JAX gang mesh lays
devices out), and each schedule is emulated step for step over them, so
its sums are taken in the JAX schedule's order:

- ``flat``: one psum over every rank;
- ``ring``: a ring all-reduce over the data axis (``ring_allreduce``'s
  2·(n-1) permute steps), then a psum over pods;
- ``hierarchical``: reduce-scatter over data (rank (p, d) owns shard d of
  its pod's sum), psum of the shards over pods, all-gather over data;
- ``compressed``: as hierarchical, but each (pod, data) shard (plus its
  error-feedback residual) goes through the threshold-select codec and
  only its (vals, idx) cross the pod boundary, sum-merged on arrival.
  All shards share one geometry, so ONE codec launch covers every shard.
  ``frac = 1.0`` is bit-exact to hierarchical.

Every rank ends with the same mean, so ``tree_sync`` returns it once.
Ranks come as an iterable and are consumed in rank order: the
hierarchical and compressed schedules add each rank's gradient into its
pod's accumulator as it arrives, so a caller that computes gradients
lazily never holds more than one rank's at a time.

Trees flatten in ``jax.tree.flatten`` order (``weights.tree_leaves``), so
the flat vector, its chunk boundaries and the codec's picks are the JAX
package's.  The HLO accounting and the collective tuner of the JAX module
come with the fabric (ROADMAP, slice (c)).
"""
from __future__ import annotations

from typing import Any, Iterable, List, Optional, Tuple

import torch

from repro_torch.kernels.collective_codec import ops as codec_ops
from repro_torch.weights import tree_leaves, tree_map, tree_unflatten

MODES = ("flat", "ring", "hierarchical", "compressed")


# ---------------------------------------------------------------------------
# Tree <-> padded flat vector (gradient bucketing)
# ---------------------------------------------------------------------------
def flatten_spec(tree, pad_to: int = 1):
    """(spec, pad) for ``flatten_tree``/``unflatten_tree`` of ``tree``."""
    leaves = tree_leaves(tree)
    sizes = [int(x.numel()) for x in leaves]
    pad = (-sum(sizes)) % pad_to
    skeleton = tree_map(lambda _: 0, tree)     # structure, no tensors
    return (skeleton, sizes, [tuple(x.shape) for x in leaves],
            [x.dtype for x in leaves]), pad


def flatten_tree(tree, pad_to: int = 1, out: Optional[torch.Tensor] = None,
                 add: bool = False):
    """Concatenate all leaves into one f32 vector, padded with zeros to a
    multiple of ``pad_to``.  With ``out`` the leaves are written (or, with
    ``add``, added) into it in place of a new vector."""
    spec, pad = flatten_spec(tree, pad_to)
    sizes = spec[1]
    n = sum(sizes) + pad
    leaves = tree_leaves(tree)
    if out is None:
        out = torch.empty(n, dtype=torch.float32, device=leaves[0].device)
        add = False
    elif out.shape != (n,) or out.dtype != torch.float32:
        raise ValueError(f"flatten_tree: out must be ({n},) f32")
    off = 0
    for leaf, size in zip(leaves, sizes):
        dst = out[off:off + size]
        if add:
            dst.add_(leaf.reshape(-1))
        else:
            dst.copy_(leaf.reshape(-1))
        off += size
    if pad and not add:
        out[off:].zero_()
    return out, spec


def unflatten_tree(vec: torch.Tensor, spec):
    """Split ``vec`` back into the spec's leaves, each cast to its own
    dtype (a bf16 model's synced gradients are rounded to bf16 here, as in
    the JAX package)."""
    like, sizes, shapes, dtypes = spec
    parts, off = [], 0
    for size, shape, dtype in zip(sizes, shapes, dtypes):
        parts.append(vec[off:off + size].reshape(shape).to(dtype))
        off += size
    return tree_unflatten(like, parts)


def padded_size(tree, n_ranks: int) -> int:
    total = sum(x.numel() for x in tree_leaves(tree))
    return total + (-total) % n_ranks


def init_residual_buffer(tree, pods: int, data: int,
                         device=None) -> torch.Tensor:
    """Zero error-feedback buffer, (pods, padded flat size) f32: row p,
    shard d is rank (p, d)'s residual, as the JAX buffer sharded
    P('pod', 'data')."""
    leaves = tree_leaves(tree)
    dev = device if device is not None else leaves[0].device
    return torch.zeros((pods, padded_size(tree, pods * data)),
                       dtype=torch.float32, device=dev)


# ---------------------------------------------------------------------------
# The schedules over virtual ranks
# ---------------------------------------------------------------------------
def _ranks(per_rank: Iterable[Any], n_ranks: int):
    """Yield (rank, tree) in rank order; raise unless there are exactly
    ``n_ranks``."""
    count = 0
    for r, tree in enumerate(per_rank):
        if r >= n_ranks:
            raise ValueError(f"tree_sync: more than {n_ranks} ranks")
        yield r, tree
        del tree                # the caller's copy is its only reference
        count = r + 1
    if count != n_ranks:
        raise ValueError(f"tree_sync: got {count} ranks, need {n_ranks}")


def _pod_sums(per_rank, pods: int, data: int):
    """Sum each pod's ranks into one vector as the ranks arrive: the
    reduce-scatter over the data axis, where shard d of pod p's vector is
    the shard rank (p, d) owns.  Returns (pods, padded) f32 and the spec."""
    n_ranks = pods * data
    acc = spec = None
    for r, tree in _ranks(per_rank, n_ranks):
        if acc is None:
            spec, pad = flatten_spec(tree, n_ranks)
            acc = torch.empty((pods, sum(spec[1]) + pad),
                              dtype=torch.float32,
                              device=tree_leaves(tree)[0].device)
        flatten_tree(tree, n_ranks, out=acc[r // data], add=r % data != 0)
        del tree
    return acc, spec


def _ring_allreduce(chunks: List[torch.Tensor]) -> torch.Tensor:
    """``ring_allreduce`` over one pod's ranks, permute for permute: each
    rank's vector as (n, len/n) chunks; 2·(n-1) steps, rank r sending to
    r+1.  Returns the (common) result."""
    n = len(chunks)
    if n == 1:
        return chunks[0].reshape(-1)
    for s in range(n - 1):          # reduce-scatter ring
        sent = [chunks[r][(r - s) % n].clone() for r in range(n)]
        for r in range(n):
            dst = (r + 1) % n
            chunks[dst][(dst - s - 1) % n].add_(sent[r])
    for s in range(n - 1):          # all-gather ring
        sent = [chunks[r][(r - s + 1) % n].clone() for r in range(n)]
        for r in range(n):
            dst = (r + 1) % n
            chunks[dst][(dst - s) % n].copy_(sent[r])
    return chunks[0].reshape(-1)


def tree_sync(per_rank: Iterable[Any], mode: str, pods: int, data: int,
              compress_frac: Optional[float] = None,
              resid: Optional[torch.Tensor] = None
              ) -> Tuple[Any, Optional[torch.Tensor]]:
    """All-reduce-mean the gradient trees of ``pods × data`` ranks.

    ``per_rank``: the ranks' trees (or flat tensors), in rank order, as
    any iterable (a list, a generator, the rows of a stacked tensor).
    ``resid``: the (pods, padded) error-feedback buffer of mode
    ``compressed``; its shards are overwritten in place with the codec's
    new residual.  Returns (mean tree, new residual or None)."""
    if mode not in MODES:
        raise ValueError(f"tree_sync: mode {mode!r} not in {MODES}")
    n_ranks = pods * data
    new_resid = None
    if mode == "flat":
        out = None
        for _, tree in _ranks(per_rank, n_ranks):
            vec, spec = flatten_tree(tree, n_ranks)
            out = vec if out is None else out.add_(vec)
            del tree, vec
    elif mode == "ring":
        out = None
        ring: List[torch.Tensor] = []
        for _, tree in _ranks(per_rank, n_ranks):
            vec, spec = flatten_tree(tree, n_ranks)
            ring.append(vec.reshape(data, -1))
            del tree, vec
            if len(ring) == data:
                pod_out = _ring_allreduce(ring)
                ring = []
                out = pod_out if out is None else out.add_(pod_out)
    elif mode == "hierarchical":
        acc, spec = _pod_sums(per_rank, pods, data)
        out = acc[0]
        for p in range(1, pods):
            out.add_(acc[p])
    else:
        if compress_frac is None or pods < 2:
            raise ValueError("tree_sync: compressed needs compress_frac and "
                             "pods >= 2 (a slow axis)")
        acc, spec = _pod_sums(per_rank, pods, data)
        length = acc.shape[1] // data
        if resid is not None:
            if resid.shape != acc.shape:
                raise ValueError(f"tree_sync: residual {tuple(resid.shape)}"
                                 f", need {tuple(acc.shape)}")
            acc.add_(resid)
        shards = acc.view(pods * data, length)
        vals, idx, new_resid = codec_ops.select_codec_shards(
            shards, frac=float(compress_frac),
            out_resid=resid.view(pods * data, length)
            if resid is not None else None)
        del acc, shards
        out = torch.zeros(data * length, dtype=torch.float32,
                          device=vals.device)
        for d in range(data):
            merged = out[d * length:(d + 1) * length]
            for p in range(pods):
                r = p * data + d
                merged.index_add_(0, idx[r], vals[r])
        new_resid = new_resid.view(pods, data * length)
    out.div_(n_ranks)
    return unflatten_tree(out, spec), new_resid
