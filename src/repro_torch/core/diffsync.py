"""Byte-wise-diff synchronisation of shared state (paper §4, Table 3;
PyTorch port of ``repro.core.diffsync``).

Every state leaf is viewed as a sequence of 1024-element chunks (the page
analogue); dirty chunks are found by comparing against the parent
snapshot, and only dirty chunks travel.  Three representations, as in the
JAX package:

* **sparse** (host side: checkpoints, migration): per-leaf ``(chunk_idx,
  payload)`` rows on the CPU (``LeafDiff``, ``diff_leaf``, ``apply_leaf``,
  ``apply_many``, ``diff_tree``, ``apply_tree``);
* **tracked** (``TrackedFork``): a chunk-granular copy-on-write fork of a
  host buffer that records its dirty chunks as writes land;
* **dense-mask** (``dense_diff``, ``dense_merge``): (mask, delta) tensors
  of static shape on any device; and ``fused_diff_apply``, which sends a
  CUDA leaf of ``KERNEL_MIN_ELEMS`` elements or more through the
  hand-written ``kernels.diff_merge`` kernel, as the JAX function sends a
  large leaf on a TPU through its Pallas kernel.

Merge operations follow Table 3 (A0 main value, B0 the child's value at
the fork, B1 the child's value after running, A1 the merged main value):
    sum        A1 = A0 + (B1 - B0)
    subtract   A1 = A0 - (B0 - B1)
    multiply   A1 = A0 * (B1 / B0)
    divide     A1 = A0 / (B0 / B1)
    overwrite  A1 = B1
On the host path float leaves compute in float64 and round once to the
leaf dtype; integer leaves are exact for sum, subtract and overwrite.

Leaves are tensors; a Python ``int`` leaf (the optimizer's step count) is
an int32 scalar here, as the JAX package's step is, and ``apply_tree``
gives it back as an ``int``.  Host rows are CPU tensors, bf16 included.
The JAX package's ``reference_*`` implementations are not copied: the
tests hold the port against the JAX package's own functions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.diff_merge.ref import CHUNK, MERGE_OPS, \
    to_leaf_dtype
from repro_torch.weights import tree_leaves, tree_leaves_with_path, \
    tree_unflatten

__all__ = ["CHUNK", "MERGE_OPS", "KERNEL_MIN_ELEMS", "merge_scalarwise",
           "LeafDiff", "diff_leaf", "apply_leaf", "apply_many", "diff_tree",
           "apply_tree", "diff_nbytes", "tree_nbytes", "TrackedFork",
           "fused_diff_apply", "dense_diff", "dense_merge"]

# leaves with at least this many elements go to the kernels/diff_merge
# kernel when they lie on a CUDA device (``fused_diff_apply``); smaller
# leaves stay on the host path, where a launch would cost more than it saves
KERNEL_MIN_ELEMS = 1 << 20


def as_tensor(leaf) -> torch.Tensor:
    """A state leaf as a tensor: an ``int`` becomes an int32 scalar."""
    if isinstance(leaf, int):
        return torch.tensor(leaf, dtype=torch.int32)
    return leaf.detach() if leaf.requires_grad else leaf


def _host(leaf) -> torch.Tensor:
    t = as_tensor(leaf)
    return t if t.device.type == "cpu" else t.cpu()


def _is_int(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex


def merge_scalarwise(a0, b0, b1, op: str) -> torch.Tensor:
    """Apply one Table-3 merge op elementwise on the host, keeping the
    dtype: float leaves compute in float64 and round once; integer
    leaves use exact integer arithmetic for sum/subtract/overwrite."""
    if op == "overwrite":
        return b1.to(a0.dtype)
    if _is_int(a0.dtype) and op in ("sum", "subtract"):
        b0i, b1i = b0.to(a0.dtype), b1.to(a0.dtype)
        if op == "sum":
            return a0 + (b1i - b0i)
        return a0 - (b0i - b1i)
    a0d, b0d, b1d = a0.double(), b0.double(), b1.double()
    if op == "sum":
        out = a0d + (b1d - b0d)
    elif op == "subtract":
        out = a0d - (b0d - b1d)
    elif op == "multiply":
        out = torch.where(b0d == 0, a0d, a0d * (b1d / b0d))
    elif op == "divide":
        out = torch.where(b1d == 0, a0d, a0d / (b0d / b1d))
    else:
        raise ValueError(op)
    return out.to(a0.dtype)


# ---------------------------------------------------------------------------
# Sparse (host-side) diff lists: the migration/checkpoint wire format
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LeafDiff:
    """Diff of one state leaf: dirty chunk indices and their contents.

    ``new``/``old`` rows align with ``idx``; the tail chunk of a ragged
    leaf is zero-padded to full width.  Rows may be views into live
    buffers (contiguous dirty runs): treat a LeafDiff as immutable."""
    idx: torch.Tensor       # (k,) int32 dirty chunk indices
    new: torch.Tensor       # (k, CHUNK) values after execution (B1)
    old: torch.Tensor       # (k, CHUNK) values at fork (B0)
    shape: Tuple[int, ...]
    dtype: torch.dtype
    op: str = "overwrite"

    @property
    def nbytes(self) -> int:
        return int(self.idx.nbytes + self.new.nbytes
                   + (0 if self.op == "overwrite" else self.old.nbytes))


def _flat_view(a: torch.Tensor) -> torch.Tensor:
    """Flat view (a copy only for a non-contiguous tensor)."""
    return a.reshape(-1)


def _body_tail(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (n_full, CHUNK) body view of a flat buffer and its ragged tail."""
    n_full = flat.numel() // CHUNK
    return flat[:n_full * CHUNK].view(n_full, CHUNK), flat[n_full * CHUNK:]


def _pad_chunk(vals: torch.Tensor) -> torch.Tensor:
    """One ragged tail as a zero-padded (1, CHUNK) row."""
    row = vals.new_zeros((1, CHUNK))
    row[0, :vals.numel()] = vals
    return row


def _gather(body: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Chunk rows; a contiguous run is a view, not a copy."""
    if idx.numel() and int(idx[-1]) - int(idx[0]) == idx.numel() - 1:
        return body[int(idx[0]):int(idx[-1]) + 1]
    return body[idx.long()]


def _nonzero32(mask: torch.Tensor) -> torch.Tensor:
    return torch.nonzero(mask).reshape(-1).to(torch.int32)


def diff_leaf(old, new, op: str = "overwrite") -> LeafDiff:
    """Chunk-wise compare ``new`` against the fork snapshot ``old``: one
    compare over the chunk body plus a check of the ragged tail."""
    old, new = _host(old), _host(new)
    assert old.shape == new.shape and old.dtype == new.dtype
    ob, ot = _body_tail(_flat_view(old))
    nb, nt = _body_tail(_flat_view(new))
    idx = _nonzero32((ob != nb).any(dim=1))
    new_rows, old_rows = _gather(nb, idx), _gather(ob, idx)
    if ot.numel() and bool((ot != nt).any()):
        idx = torch.cat([idx, torch.tensor([ob.shape[0]],
                                           dtype=torch.int32)])
        new_rows = torch.cat([new_rows, _pad_chunk(nt)])
        old_rows = torch.cat([old_rows, _pad_chunk(ot)])
    return LeafDiff(idx=idx, new=new_rows, old=old_rows,
                    shape=tuple(old.shape), dtype=old.dtype, op=op)


def _split_tail_idx(d: LeafDiff, n_full: int) -> Tuple[torch.Tensor, bool]:
    """Body chunk indices of ``d`` and whether its last row is the tail."""
    has_tail = bool(d.idx.numel()) and int(d.idx[-1]) == n_full
    return (d.idx[:-1] if has_tail else d.idx), has_tail


def apply_leaf(main, d: LeafDiff, inplace: bool = False) -> torch.Tensor:
    """Merge a LeafDiff into the main copy (A0 -> A1, Table 3).  An empty
    diff passes ``main`` through; otherwise only the dirty chunks are
    gathered, merged and scattered back, into a copy of ``main`` or, with
    ``inplace=True``, into ``main`` itself."""
    main = _host(main)
    if d.idx.numel() == 0:
        return main
    out = main if inplace else main.clone(
        memory_format=torch.contiguous_format)
    body, tail = _body_tail(_flat_view(out))
    body_idx, has_tail = _split_tail_idx(d, body.shape[0])
    k = body_idx.numel()
    if k:
        a0 = _gather(body, body_idx)
        body[body_idx.long()] = merge_scalarwise(a0, d.old[:k], d.new[:k],
                                                 d.op)
    if has_tail:
        mt = merge_scalarwise(_pad_chunk(tail), d.old[-1:], d.new[-1:], d.op)
        tail[:] = mt[0, :tail.numel()]
    return out


def apply_many(main, diffs: Sequence[LeafDiff],
               inplace: bool = False) -> torch.Tensor:
    """Merge several diffs of the same leaf into ``main`` in order (N
    workers merging back, paper §4.2), with one materialisation: chunks
    no diff touches are copied from ``main`` once (never with
    ``inplace=True``).  The first diff touching a chunk merges against
    ``main``'s value, later ones against the accumulated result, as
    sequential ``apply_leaf`` calls would."""
    main = _host(main)
    diffs = [d for d in diffs if d.idx.numel()]
    if not diffs:
        return main
    body_main, tail_main = _body_tail(_flat_view(main))
    n_full = body_main.shape[0]
    if inplace:
        out = main
    else:
        out = torch.empty_like(main, memory_format=torch.contiguous_format)
        body_o, tail_o = _body_tail(_flat_view(out))
        covered = torch.zeros(n_full + (1 if tail_o.numel() else 0),
                              dtype=torch.bool)
        for d in diffs:
            covered[d.idx.long()] = True
        clean = _nonzero32(~covered[:n_full])
        if clean.numel():
            body_o[clean.long()] = _gather(body_main, clean)
        if tail_o.numel() and not bool(covered[n_full]):
            tail_o[:] = tail_main
    body, tail = _body_tail(_flat_view(out))
    written = torch.zeros(n_full + 1, dtype=torch.bool)     # +1: tail slot
    for d in diffs:
        body_idx, has_tail = _split_tail_idx(d, n_full)
        k = body_idx.numel()
        if k:
            rows = body_idx.long()
            first = ~written[rows]
            if inplace or not bool(first.any()):
                a0 = _gather(body, body_idx)
            elif bool(first.all()):
                a0 = _gather(body_main, body_idx)
            else:
                a0 = _gather(body, body_idx).clone()
                a0[first] = body_main[rows[first]]
            body[rows] = merge_scalarwise(a0, d.old[:k], d.new[:k], d.op)
            written[rows] = True
        if has_tail:
            src = tail if (inplace or bool(written[n_full])) else tail_main
            mt = merge_scalarwise(_pad_chunk(src), d.old[-1:], d.new[-1:],
                                  d.op)
            tail[:] = mt[0, :tail.numel()]
            written[n_full] = True
    return out


def diff_tree(old_tree, new_tree, op: str = "overwrite") -> Dict[str, Any]:
    """Diff two state trees -> {path: LeafDiff} for the dirty leaves only;
    a path is the JAX package's ``keystr`` of the leaf."""
    diffs = {}
    for (path, o), n in zip(tree_leaves_with_path(old_tree),
                            tree_leaves(new_tree)):
        d = diff_leaf(o, n, op=op)
        if d.idx.numel():
            diffs[path] = d
    return diffs


def apply_tree(main_tree, diffs: Dict[str, Any], inplace: bool = False):
    """Merge a diff dict into the main tree; returns the merged tree.

    Untouched leaves pass through as they are (no copy), and the dirty
    leaves' merges are stacked: all dirty chunks sharing a (merge op,
    dtype) are gathered across leaves into one ``merge_scalarwise``
    call."""
    keyed = tree_leaves_with_path(main_tree)
    out: List[Any] = [leaf for _, leaf in keyed]
    touched = [(i, diffs[key]) for i, (key, _) in enumerate(keyed)
               if key in diffs and diffs[key].idx.numel()]
    groups: Dict[Tuple[str, torch.dtype], List[Tuple[int, LeafDiff]]] = {}
    for i, d in touched:
        groups.setdefault((d.op, d.dtype), []).append((i, d))
    for (op, _), members in groups.items():
        a0_rows, old_rows, new_rows, spans = [], [], [], []
        for i, d in members:
            main = _host(out[i])
            target = main if inplace and not isinstance(out[i], int) \
                else main.clone(memory_format=torch.contiguous_format)
            body, tail = _body_tail(_flat_view(target))
            body_idx, has_tail = _split_tail_idx(d, body.shape[0])
            k = body_idx.numel()
            if k:
                a0_rows.append(_gather(body, body_idx))
                old_rows.append(d.old[:k])
                new_rows.append(d.new[:k])
            if has_tail:
                a0_rows.append(_pad_chunk(tail))
                old_rows.append(d.old[-1:])
                new_rows.append(d.new[-1:])
            spans.append((i, target, body_idx, k, has_tail))
        merged = merge_scalarwise(torch.cat(a0_rows), torch.cat(old_rows),
                                  torch.cat(new_rows), op)
        row = 0
        for i, target, body_idx, k, has_tail in spans:
            body, tail = _body_tail(_flat_view(target))
            if k:
                body[body_idx.long()] = merged[row:row + k]
                row += k
            if has_tail:
                tail[:] = merged[row, :tail.numel()]
                row += 1
            out[i] = int(target) if isinstance(out[i], int) else target
    return tree_unflatten(main_tree, out)


def diff_nbytes(diffs: Dict[str, Any]) -> int:
    return sum(d.nbytes for d in diffs.values())


def tree_nbytes(tree) -> int:
    """Total bytes of a state tree (the full-snapshot size a delta is
    measured against); an ``int`` leaf counts as an int32."""
    return int(sum(as_tensor(leaf).nbytes for leaf in tree_leaves(tree)))


# ---------------------------------------------------------------------------
# TrackedFork: the mprotect write-tracking analogue for host buffers
# ---------------------------------------------------------------------------
class TrackedFork:
    """Chunk-granular copy-on-write fork of a host buffer.

    Writes go through ``writable`` / ``__setitem__``, which materialise
    only the touched chunks (boundary chunks copy in from the base) and
    record them in a dirty mask, so fork and diff costs scale with dirty
    bytes: ``diff`` builds a ``LeafDiff`` straight from the mask
    (chunk-pessimistic, like page-granular tracking; ``verify=True``
    re-compares the dirty chunks to drop false positives).  The base is
    never written."""

    def __init__(self, base: torch.Tensor):
        self.base = _host(base)
        self._flat_base = _flat_view(self.base)
        self._buf = torch.empty_like(self.base,
                                     memory_format=torch.contiguous_format)
        self._flat = _flat_view(self._buf)
        self._n_chunks = -(-self._flat.numel() // CHUNK)
        self._dirty = torch.zeros(self._n_chunks, dtype=torch.bool)

    def _materialize(self, lo: int, hi: int) -> None:
        """Mark the chunks of elements [lo, hi) dirty; copy boundary
        (partly covered) chunks in from the base first."""
        c0, c1 = lo // CHUNK, -(-hi // CHUNK)
        for c, edge_lo, edge_hi in ((c0, c0 * CHUNK, lo),
                                    (c1 - 1, hi, c1 * CHUNK)):
            if edge_lo < edge_hi and not bool(self._dirty[c]):
                s = slice(c * CHUNK, min((c + 1) * CHUNK,
                                         self._flat.numel()))
                self._flat[s] = self._flat_base[s]
        self._dirty[c0:c1] = True

    def _span(self, key) -> Tuple[int, int]:
        if isinstance(key, slice):
            lo, hi, step = key.indices(self._flat.numel())
            assert step == 1, "TrackedFork writes must be unit-stride"
            return lo, max(lo, hi)
        i = int(key)
        if i < 0:
            i += self._flat.numel()
        return i, i + 1

    def writable(self, key) -> torch.Tensor:
        """A writable view of the fork's buffer over a flat slice: the
        caller writes values straight into fork storage
        (``torch.mul(base[sl], 1.01, out=fork.writable(sl))``)."""
        lo, hi = self._span(key)
        self._materialize(lo, hi)
        return self._flat[lo:hi]

    def __setitem__(self, key, values) -> None:
        lo, hi = self._span(key)
        self._materialize(lo, hi)
        self._flat[lo:hi] = values

    def __getitem__(self, key) -> torch.Tensor:
        """Read-through: dirty chunks from the fork, clean from the base."""
        lo, hi = self._span(key)
        c0, c1 = lo // CHUNK, -(-hi // CHUNK)
        if bool(self._dirty[c0:c1].all()):
            return self._flat[lo:hi]
        if not bool(self._dirty[c0:c1].any()):
            return self._flat_base[lo:hi]
        out = self._flat_base[lo:hi].clone()
        for c in range(c0, c1):
            if bool(self._dirty[c]):
                s0, s1 = max(lo, c * CHUNK), min(hi, (c + 1) * CHUNK)
                out[s0 - lo:s1 - lo] = self._flat[s0:s1]
        return out

    @property
    def dirty_chunks(self) -> torch.Tensor:
        return _nonzero32(self._dirty)

    def diff(self, op: str = "overwrite", verify: bool = False) -> LeafDiff:
        """The fork's LeafDiff against its base, from the write-tracking
        mask: no state-sized compare."""
        idx = self.dirty_chunks
        body_b, tail_b = _body_tail(self._flat_base)
        body_f, tail_f = _body_tail(self._flat)
        n_full = body_f.shape[0]
        if verify and idx.numel():
            body_idx = idx[idx < n_full]
            keep = (body_b[body_idx.long()] != body_f[body_idx.long()]) \
                .any(dim=1)
            kept = body_idx[keep]
            if int(idx[-1]) == n_full and tail_b.numel() \
                    and bool((tail_b != tail_f).any()):
                kept = torch.cat([kept, idx[-1:]])
            idx = kept.to(torch.int32)
        body_idx = idx[idx < n_full]
        new_rows, old_rows = _gather(body_f, body_idx), \
            _gather(body_b, body_idx)
        if idx.numel() and int(idx[-1]) == n_full:
            new_rows = torch.cat([new_rows, _pad_chunk(tail_f)])
            old_rows = torch.cat([old_rows, _pad_chunk(tail_b)])
        return LeafDiff(idx=idx, new=new_rows, old=old_rows,
                        shape=tuple(self.base.shape), dtype=self.base.dtype,
                        op=op)


# ---------------------------------------------------------------------------
# Fused diff + merge: large CUDA leaves go through kernels/diff_merge
# ---------------------------------------------------------------------------
def fused_diff_apply(main, fork, child, op: str = "sum",
                     use_kernel: Optional[bool] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused pass over a leaf: dirty detection against the fork
    snapshot and the Table-3 merge into ``main``.  Returns ``(merged,
    dirty chunk mask)`` on ``main``'s device.

    ``use_kernel=None`` sends a CUDA leaf of ``KERNEL_MIN_ELEMS`` elements
    or more to the ``kernels.diff_merge`` kernel (one streaming pass at
    memory speed) and keeps every other leaf on the host path, with its
    float64 rounding.  ``True`` sends the leaf to ``diff_merge_leaf`` (the
    kernel on a CUDA tensor, its plain version on a CPU one); ``False``
    keeps it on the host path."""
    main, fork, child = as_tensor(main), as_tensor(fork), as_tensor(child)
    if use_kernel is None:
        use_kernel = main.is_cuda and main.numel() >= KERNEL_MIN_ELEMS
    if use_kernel:
        from repro_torch.kernels.diff_merge import ops as _kops
        return _kops.diff_merge_leaf(main, fork, child, op=op)
    d = diff_leaf(fork, child, op=op)
    merged = apply_leaf(main, d)
    dirty = torch.zeros(-(-main.numel() // CHUNK), dtype=torch.bool)
    dirty[d.idx.long()] = True
    return merged.to(main.device), dirty.to(main.device)


# ---------------------------------------------------------------------------
# Dense-mask diffs (static shapes, any device)
# ---------------------------------------------------------------------------
def _chunk_rows(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % CHUNK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, CHUNK)


def dense_diff(old: torch.Tensor, new: torch.Tensor):
    """Chunk diff of static shape: (dirty mask (n_chunks,), delta) with
    delta = new - old in chunk rows (the payload of op=sum)."""
    fo, fn = _chunk_rows(old), _chunk_rows(new)
    return (fo != fn).any(dim=1), fn - fo


def _dense_compute_dtype(dtype: torch.dtype, op: str) -> torch.dtype:
    """Dtype the dense merge runs in: integers stay integers for the
    exact ops, f32/f64 keep their precision, bf16/f16 go to f32."""
    if _is_int(dtype):
        return dtype if op in ("sum", "subtract", "overwrite") \
            else torch.float32
    if dtype in (torch.float32, torch.float64):
        return dtype
    return torch.float32


def dense_merge(main: torch.Tensor, mask: torch.Tensor, payload: torch.Tensor,
                op: str = "sum") -> torch.Tensor:
    """Merge a dense-mask diff into ``main``.  The payload is B1 - B0 for
    sum and subtract, B1 for overwrite and B1 / B0 for multiply and
    divide; the merge runs in ``_dense_compute_dtype`` of the leaf."""
    cdt = _dense_compute_dtype(main.dtype, op)
    fm = _chunk_rows(main).to(cdt)
    p = payload.to(cdt)
    if op == "sum":
        merged = fm + p
    elif op == "subtract":
        merged = fm - (-p)      # A1 = A0 - (B0 - B1) = A0 + (B1 - B0)
    elif op == "multiply":
        merged = fm * p
    elif op == "divide":
        merged = fm / torch.where(p == 0, torch.ones((), dtype=cdt,
                                                     device=p.device), p)
    elif op == "overwrite":
        merged = p
    else:
        raise ValueError(op)
    out = torch.where(mask[:, None], merged, fm)
    return to_leaf_dtype(out.reshape(-1)[:main.numel()].view(main.shape),
                         main.dtype)
