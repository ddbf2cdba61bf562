"""Plain PyTorch version of the collective_codec kernel (the kernel's
oracle, and what the wrapper computes for a tensor on the CPU).

Operation for operation the JAX package's ``chunk_select_ref`` (first
argmax as the least lane among the maxima of |x|, the value as a masked
row sum), so the two agree bit for bit, ties and NaN rows included."""
from __future__ import annotations

import torch


def chunk_select_ref(x: torch.Tensor):
    """x: (k, m) -> (vals (k, 1), col (k, 1) int32, resid (k, m))."""
    k, m = x.shape
    mag = x.abs()
    lane = torch.arange(m, dtype=torch.int32, device=x.device)[None, :]
    rowmax = mag.amax(dim=1, keepdim=True)
    col = torch.where(mag == rowmax, lane,
                      torch.full_like(lane, m)).amin(dim=1, keepdim=True)
    picked = lane == col
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    vals = torch.where(picked, x, zero).sum(dim=1, keepdim=True)
    resid = torch.where(picked, zero, x)
    return vals, col.to(torch.int32), resid
