"""Wrapper of the diff_merge kernel: one fused pass over a state leaf that
finds its dirty 1024-element chunks against the fork snapshot and merges
them into the main copy with a Table-3 merge op (PyTorch port of
``repro.kernels.diff_merge.ops``).

A CUDA tensor goes to the hand-written kernel (``csrc/diff_merge.cu``) or
the call raises; a CPU tensor goes to the plain version
(``ref.diff_merge_leaf_ref``).  There is no fallback from one to the other.
Which leaves are worth the kernel is ``core.diffsync.fused_diff_apply``'s
decision, as in the JAX package.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.diff_merge.ref import (CHUNK, MERGE_OPS,
                                                diff_merge_leaf_ref)

launches = 0            # kernel launches since the last reset

_SOURCE = Path(__file__).resolve().parent / "csrc" / "diff_merge.cu"
_SIG = {"dm_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p,  # a0 b0 b1 a1 dirty
                      ctypes.c_longlong, ctypes.c_int,   # n, dtype
                      ctypes.c_int, ctypes.c_void_p]}    # op, stream
DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
          torch.float16: 3, torch.int32: 4, torch.int64: 5}


def reset_launches() -> None:
    global launches
    launches = 0


def work(n: int, esize: int) -> tuple:
    """(flops, bytes) of one fused pass over a leaf of n ``esize``-byte
    elements: a0, b0, b1 read once, a1 written once, one dirty byte per
    chunk; no floating-point products counted."""
    return 0.0, 4 * n * esize + -(-n // CHUNK)


def lib():
    from repro_torch.kernels import _build
    return _build.load("diff_merge", _SOURCE, _SIG)


def _check(a0: torch.Tensor, b0: torch.Tensor, b1: torch.Tensor,
           op: str) -> None:
    if op not in MERGE_OPS:
        raise ValueError(f"diff_merge: op {op!r} not in {MERGE_OPS}")
    if not (a0.shape == b0.shape == b1.shape
            and a0.dtype == b0.dtype == b1.dtype
            and a0.device == b0.device == b1.device):
        raise ValueError("diff_merge: a0, b0 and b1 need one shape, dtype "
                         "and device")


def _launch(a0: torch.Tensor, b0: torch.Tensor, b1: torch.Tensor, op: str):
    """The kernel on three contiguous CUDA tensors of one shape and dtype
    -> (a1 like a0, dirty (ceil(n / 1024),) bool)."""
    global launches
    _check(a0, b0, b1, op)
    if not a0.is_cuda or a0.dtype not in DTYPES:
        raise TypeError("diff_merge: need a CUDA tensor of "
                        f"{sorted(str(d) for d in DTYPES)}, got {a0.dtype} "
                        f"on {a0.device}")
    if not all(x.is_contiguous() for x in (a0, b0, b1)):
        raise ValueError("diff_merge: a0, b0 and b1 must be contiguous")
    n = a0.numel()
    a1 = torch.empty_like(a0, memory_format=torch.contiguous_format)
    dirty = torch.empty((-(-n // CHUNK),), dtype=torch.bool,
                        device=a0.device)
    if n == 0:
        return a1, dirty
    handle = lib()
    stream = torch.cuda.current_stream(a0.device).cuda_stream
    with torch.cuda.device(a0.device):
        err = handle.dm_launch(a0.data_ptr(), b0.data_ptr(), b1.data_ptr(),
                               a1.data_ptr(), dirty.data_ptr(), n,
                               DTYPES[a0.dtype], MERGE_OPS.index(op), stream)
    if err != 0:
        raise RuntimeError(f"diff_merge: CUDA error {err} at launch")
    launches += 1
    return a1, dirty


def diff_merge_leaf(a0: torch.Tensor, b0: torch.Tensor, b1: torch.Tensor, *,
                    op: str = "sum"):
    """a0 = main value, b0 = fork snapshot, b1 = child value (one shape,
    dtype and device) -> (merged like a0, dirty (n_chunks,) bool): the
    kernel on CUDA tensors, the plain version on CPU ones."""
    _check(a0, b0, b1, op)
    if a0.is_cuda:
        return _launch(a0.contiguous(), b0.contiguous(), b1.contiguous(), op)
    return diff_merge_leaf_ref(a0, b0, b1, op=op)
