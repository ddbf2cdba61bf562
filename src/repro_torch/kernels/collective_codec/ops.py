"""Wrapper of the collective_codec kernel: threshold-select a flat
gradient shard into a fixed-size sparse (vals, idx) message plus its
error-feedback residual (PyTorch port of
``repro.kernels.collective_codec.ops``).

The shard is padded into ``(k, m)`` chunk rows (``k = max(1, int(n·frac))``
selected elements, ``m = ceil(n / k)``) and each row gives its
largest-magnitude element.  A CUDA tensor goes to the hand-written kernel
(``csrc/collective_codec.cu``) whatever its size, or the call raises; a CPU
tensor goes to the plain version (``ref.chunk_select_ref``).  There is no
fallback from one to the other and no size threshold (the JAX package's
``KERNEL_MIN_SIZE`` is a TPU launch-cost rule the port does not copy).
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.collective_codec.ref import chunk_select_ref

launches = 0            # kernel launches since the last reset

_SOURCE = Path(__file__).resolve().parent / "csrc" / "collective_codec.cu"
_SIG = {"cc_select": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p,                  # x, vals, col, resid
                      ctypes.c_longlong, ctypes.c_int,  # rows, m
                      ctypes.c_void_p]}                 # stream
MAX_M = 12287           # widest chunk row a kernel tile holds


def reset_launches() -> None:
    global launches
    launches = 0


def work(rows: int, m: int) -> tuple:
    """(flops, bytes) of one launch on a (rows, m) f32 shard: x read and
    the residual written once (4 bytes each), a value and an int32 column
    written per row; no floating-point products."""
    return 0.0, 8 * rows * m + 8 * rows


def lib():
    from repro_torch.kernels import _build
    return _build.load("collective_codec", _SOURCE, _SIG)


def _launch(x: torch.Tensor, out_resid: Optional[torch.Tensor] = None):
    """The kernel on a (rows, m) f32 CUDA tensor -> (vals (rows,),
    col (rows,) int32, resid (rows, m)).  ``out_resid`` (same shape,
    contiguous, not aliasing ``x``) receives the residual in place."""
    global launches
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError("collective_codec: need a 2-D float32 CUDA tensor, "
                        f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError("collective_codec: x must be contiguous")
    rows, m = x.shape
    if rows == 0 or not 0 < m <= MAX_M:
        raise ValueError(f"collective_codec: shape {(rows, m)}; need rows "
                         f"> 0 and 0 < m <= {MAX_M}")
    resid = out_resid if out_resid is not None else torch.empty_like(x)
    if (resid.shape != x.shape or resid.dtype != x.dtype
            or resid.device != x.device or not resid.is_contiguous()
            or resid.data_ptr() == x.data_ptr()):
        raise ValueError("collective_codec: out_resid must be a contiguous "
                         "float32 tensor of x's shape, apart from x")
    vals = torch.empty((rows,), dtype=torch.float32, device=x.device)
    col = torch.empty((rows,), dtype=torch.int32, device=x.device)
    handle = lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = handle.cc_select(x.data_ptr(), vals.data_ptr(), col.data_ptr(),
                               resid.data_ptr(), rows, m, stream)
    if err != 0:
        raise RuntimeError(f"collective_codec: CUDA error {err} at launch")
    launches += 1
    return vals, col, resid


def chunk_select(x: torch.Tensor, out_resid: Optional[torch.Tensor] = None):
    """x: (k, m) f32 -> (vals (k, 1), col (k, 1) int32, resid (k, m)): the
    kernel on a CUDA tensor, the plain version on a CPU one."""
    if x.is_cuda:
        vals, col, resid = _launch(x, out_resid)
        return vals[:, None], col[:, None], resid
    vals, col, resid = chunk_select_ref(x)
    if out_resid is not None:
        out_resid.copy_(resid)
        resid = out_resid
    return vals, col, resid


def codec_geometry(n: int, frac: float):
    """(k, m, padded) chunk geometry for an ``n``-element shard: ``k``
    selected elements (chunk rows), chunk width ``m = ceil(n/k)``.
    ``frac = 1.0`` degenerates to ``m = 1``: every element selected, which
    makes the compressed collective bit-exact to hierarchical."""
    n = int(n)
    k = max(1, min(n, int(n * frac)))
    m = -(-n // k)
    return k, m, k * m


def select_codec_shards(shards: torch.Tensor, *, frac: float,
                        out_resid: Optional[torch.Tensor] = None):
    """shards: (P, n) f32, P shards of one geometry -> (vals (P, k),
    idx (P, k) int32, resid (P, n)), in ONE kernel launch over the P·k
    chunk rows.  Per shard, ``vals[i] = shard[idx[i]]`` is the
    largest-magnitude element of chunk ``i`` and ``resid`` is the shard
    with the selected elements zeroed, so ``scatter(vals, idx) + resid``
    is the shard exactly (error feedback).  ``out_resid`` ((P, n),
    contiguous) receives the residual in place of a new tensor."""
    p, n = shards.shape
    k, m, padded = codec_geometry(n, frac)
    if padded != n:
        x = F.pad(shards, (0, padded - n)).reshape(p * k, m)
        vals, col, resid = chunk_select(x)
        resid = resid.reshape(p, padded)[:, :n]
        if out_resid is not None:
            resid = out_resid.copy_(resid)
    else:
        x = shards.contiguous().reshape(p * k, m)
        into = out_resid.view(p * k, m) if out_resid is not None else None
        vals, col, resid = chunk_select(x, into)
        resid = resid.reshape(p, n)
    # idx = chunk * m + col, built in col's memory (at frac 1.0 it is as
    # large as the shards themselves)
    idx = col.reshape(p, k)
    idx.add_(torch.arange(k, dtype=torch.int32, device=shards.device) * m)
    # padding lanes are zero, so a padded-chunk pick is (0.0, idx >= n)
    # clamped into range: scatter-adding 0.0 is a no-op either way
    idx.clamp_max_(n - 1)
    return vals.reshape(p, k), idx, resid


def select_codec(vec: torch.Tensor, *, frac: float):
    """vec: flat (n,) f32 -> (vals (k,), idx (k,) int32, resid (n,))."""
    vals, idx, resid = select_codec_shards(vec.reshape(1, -1), frac=frac)
    return vals[0], idx[0], resid[0]
