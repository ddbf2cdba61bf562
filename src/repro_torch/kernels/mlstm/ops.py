"""Wrapper of the mlstm kernel: the stabilised chunkwise mLSTM in the
model's call signature (PyTorch port of ``repro.kernels.mlstm.ops``).

``mlstm`` takes the model layout (q, k, v (B,L,H,hd), logi/logf (B,L,H))
and an optional initial state, and returns h (B,L,H,hd) and the final
state (c (B,H,hd,hd), n (B,H,hd), m (B,H)) f32, like
``models.xlstm.mlstm_chunked``.  Unlike the JAX package's wrapper it
takes the initial state and a length that is not a multiple of the chunk.
The kernel reads and writes that layout itself, so no transpose is made.
A CUDA tensor goes to the hand-written kernel (``csrc/mlstm.cu``) or the
call raises; a CPU tensor goes to the plain version
(``ref.mlstm_chunked``).  There is no fallback from one to the other.
The kernel has no backward, so on CUDA the wrapper refuses inputs that
want a gradient.  ``launches`` counts kernel launches (one per call: the
kernel's three passes run in one C call).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.mlstm.ref import mlstm_chunked

launches = 0            # kernel launches since the last reset

MAX_CHUNK = 128         # longest chunk the kernel's shared tiles hold
MAX_HEAD_DIM = 1024     # widest head a block's C tile holds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = Path(__file__).resolve().parent / "csrc" / "mlstm.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, logi, logf, c0, n0, m0, h, c, n, m, gvec, carry, nin, st, den;
# B, L, H, D, chunk, dtype; stream
_SIG = {"ml_mlstm": [_P] * 17 + [_I] * 6 + [_P]}


def reset_launches() -> None:
    global launches
    launches = 0


def lib():
    from repro_torch.kernels import _build
    return _build.load("mlstm", _SOURCE, _SIG)


def _check_shapes(q, k, v, logi, logf, state):
    if q.dim() != 4:
        raise ValueError(f"mlstm: q must be (B,L,H,hd), got "
                         f"{tuple(q.shape)}")
    bs, length, h, hd = q.shape
    if (k.shape != q.shape or v.shape != q.shape
            or logi.shape != (bs, length, h) or logf.shape != logi.shape):
        raise ValueError(f"mlstm: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} logi "
                         f"{tuple(logi.shape)} logf {tuple(logf.shape)}")
    if state is not None:
        want = ((bs, h, hd, hd), (bs, h, hd), (bs, h))
        got = tuple(tuple(t.shape) for t in state)
        if got != want:
            raise ValueError(f"mlstm: state shapes {got}, want {want}")


def _launch(q, k, v, logi, logf, state, chunk: int):
    """The kernel on contiguous CUDA tensors in the model layout."""
    global launches
    _check_shapes(q, k, v, logi, logf, state)
    ts = (q, k, v, logi, logf) + tuple(state or ())
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise TypeError("mlstm: q, k, v, logi, logf and the state must be "
                        "on one CUDA device")
    if (q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype
            or any(t.dtype != torch.float32 for t in ts[3:])):
        raise TypeError(f"mlstm: dtypes {[t.dtype for t in ts]}; need q, "
                        "k, v float32 or bfloat16 alike, the gates and the "
                        "state float32")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("mlstm: inputs must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "mlstm: the kernel has no backward yet (ROADMAP, 'The port: "
            "slices': training of the MoE, hybrid and xLSTM families)")
    bs, length, h, hd = q.shape
    qc = min(chunk, length)
    if not (bs > 0 and h > 0 and 0 < hd <= MAX_HEAD_DIM and hd % 4 == 0
            and 0 < qc <= MAX_CHUNK):
        raise ValueError(f"mlstm: B {bs}, L {length}, H {h}, head dim {hd}, "
                         f"chunk {qc}; need head dim <= {MAX_HEAD_DIM} and "
                         f"a multiple of 4, 0 < chunk <= {MAX_CHUNK}")
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    nc = -(-length // qc)
    out = torch.empty_like(q)
    c = torch.empty((bs, h, hd, hd), **f32)
    n = torch.empty((bs, h, hd), **f32)
    m = torch.empty((bs, h), **f32)
    # per (b, h, chunk): the gates' vectors, carry, the n entering the
    # chunk, S (transposed) and den
    gvec = torch.empty((bs, h, nc, 4, qc), **f32)
    carry = torch.empty((bs, h, nc), **f32)
    nin = torch.empty((bs, h, nc, hd), **f32)
    st = torch.empty((bs, h, nc, qc, qc), **f32)
    den = torch.empty((bs, h, nc, qc), **f32)
    c0, n0, m0 = (t.data_ptr() for t in state) if state is not None \
        else (None, None, None)
    handle = lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = handle.ml_mlstm(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), logi.data_ptr(),
            logf.data_ptr(), c0, n0, m0, out.data_ptr(), c.data_ptr(),
            n.data_ptr(), m.data_ptr(), gvec.data_ptr(), carry.data_ptr(),
            nin.data_ptr(), st.data_ptr(), den.data_ptr(), bs, length, h,
            hd, qc, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mlstm: CUDA error {err} at launch")
    launches += 1
    return out, (c, n, m)


def mlstm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          logi: torch.Tensor, logf: torch.Tensor, state=None, *,
          chunk: int = 128):
    """Model layout: q/k/v (B,L,H,hd); logi/logf (B,L,H); ``state`` (c
    (B,H,hd,hd), n (B,H,hd), m (B,H)) or None for the zero state.

    Returns h (B,L,H,hd) in q's dtype and the final state (c, n, m) f32:
    the kernel on CUDA tensors, the plain version on CPU ones."""
    _check_shapes(q, k, v, logi, logf, state)
    if q.is_cuda:
        if state is not None:
            state = tuple(t.float().contiguous() for t in state)
        return _launch(q.contiguous(), k.contiguous(), v.contiguous(),
                       logi.float().contiguous(), logf.float().contiguous(),
                       state, chunk)
    return mlstm_chunked(q, k, v, logi, logf, state, chunk)
