"""Plain PyTorch version of the diff_merge kernel (the kernel's oracle, and
what the wrapper computes for a tensor on the CPU).

The same formulas as the JAX package's ``diff_merge_ref`` and
``kernel._dm_kernel``, in the same compute dtype (``compute_dtype``): per
1024-element chunk, ``dirty`` compares the stored values of b0 and b1 (a
NaN is always dirty, -0 against +0 is clean), the Table-3 merge of
(a0, b0, b1) runs in the compute dtype, and ``a1 = where(dirty, merged,
a0)`` is converted back to the leaf dtype, so clean chunks pass through
that cast too.  A float-to-integer conversion truncates toward zero,
saturates at the type's range and gives 0 for NaN, as XLA's convert does.
"""
from __future__ import annotations

import torch

CHUNK = 1024
MERGE_OPS = ("sum", "subtract", "multiply", "divide", "overwrite")


def compute_dtype(dtype: torch.dtype, op: str) -> torch.dtype:
    """Dtype the merge runs in: integers stay integers for the exact ops
    (sum, subtract, overwrite) and go to f32 for multiply and divide,
    f32 and f64 keep their own precision, bf16 and f16 go to f32."""
    if not dtype.is_floating_point:
        return dtype if op in ("sum", "subtract", "overwrite") \
            else torch.float32
    if dtype in (torch.float32, torch.float64):
        return dtype
    return torch.float32


def to_leaf_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` converted to ``dtype`` as XLA converts: round to nearest for
    floats; toward zero, saturating, NaN to 0 for a float into an
    integer (PyTorch leaves out-of-range values undefined)."""
    if dtype.is_floating_point or not x.dtype.is_floating_point:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    edge = 2.0 ** (info.bits - 1)           # exact in f32 and f64
    t = torch.trunc(x)
    hi, lo = t >= edge, t < -edge
    inside = torch.where(hi | lo | torch.isnan(t), 0, t).to(dtype)
    return torch.where(hi, info.max, torch.where(lo, info.min, inside))


def _merge(a0, b0, b1, op: str):
    if op == "sum":
        return a0 + (b1 - b0)
    if op == "subtract":
        return a0 - (b0 - b1)
    if op == "multiply":
        return a0 * torch.where(b0 == 0, 1.0, b1 / b0)
    if op == "divide":
        return a0 / torch.where(b1 == 0, 1.0,
                                torch.where(b0 == 0, 1.0, b0 / b1))
    if op == "overwrite":
        return b1
    raise ValueError(op)


def diff_merge_ref(a0, b0, b1, *, op: str = "sum"):
    """a0/b0/b1: (n_chunks, chunk) -> (a1 like a0, dirty (n_chunks, 1))."""
    cdt = compute_dtype(a0.dtype, op)
    a0c = a0.to(cdt)
    merged = _merge(a0c, b0.to(cdt), b1.to(cdt), op)
    dirty = (b0 != b1).any(dim=1, keepdim=True)
    return to_leaf_dtype(torch.where(dirty, merged, a0c), a0.dtype), dirty


def diff_merge_leaf_ref(a0, b0, b1, *, op: str = "sum"):
    """A whole leaf through ``diff_merge_ref``: flattened and zero-padded
    into chunk rows, as the JAX wrapper pads it -> (merged like a0, dirty
    (n_chunks,) bool)."""
    n = a0.numel()
    pad = (-n) % CHUNK

    def tiles(x):
        flat = x.reshape(-1)
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat.view(-1, CHUNK)
    a1, dirty = diff_merge_ref(tiles(a0), tiles(b0), tiles(b1), op=op)
    return a1.reshape(-1)[:n].view(a0.shape), dirty[:, 0]
