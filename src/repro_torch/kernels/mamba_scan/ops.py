"""Wrapper of the mamba_scan kernel: the Mamba2 SSD chunked scan in the
model's call signature (PyTorch port of ``repro.kernels.mamba_scan.ops``).

``ssd`` takes the model layout (x (B,L,H,P), dt (B,L,H), a (H,), b/c
(B,L,N)) and returns y (B,L,H,P) and the final state (B,H,P,N) f32, like
``models.ssm.ssd_chunked``.  The kernel reads and writes that layout
itself, so no transpose is made.  A CUDA tensor goes to the hand-written
kernel (``csrc/mamba_scan.cu``) or the call raises; a CPU tensor goes to
the plain version (``ref.ssd_chunked``).  There is no fallback from one to
the other.  The kernel has no backward yet, so on CUDA the wrapper refuses
inputs that want a gradient.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.mamba_scan.ref import chunk_len, ssd_chunked

launches = 0            # kernel launches since the last reset

MAX_CHUNK = 64          # longest chunk a block's shared tiles hold
MAX_STATE = 64          # largest state dimension N
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, dt, a, b, c, y, s_fin; B, L, H, P, N, chunk; dtype, stream
_SIG = {"ms_ssd": [_P] * 7 + [_I] * 6 + [_I, _P]}


def reset_launches() -> None:
    global launches
    launches = 0


def lib():
    from repro_torch.kernels import _build
    return _build.load("mamba_scan", _SOURCE, _SIG)


def _check_shapes(x, dt, a, b, c):
    if x.dim() != 4:
        raise ValueError(f"mamba_scan: x must be (B,L,H,P), got "
                         f"{tuple(x.shape)}")
    bs, length, h, _ = x.shape
    n = b.shape[-1]
    if (dt.shape != (bs, length, h) or a.shape != (h,)
            or b.shape != (bs, length, n) or c.shape != b.shape):
        raise ValueError(f"mamba_scan: shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} a {tuple(a.shape)} b "
                         f"{tuple(b.shape)} c {tuple(c.shape)}")


def _launch(x, dt, a, b, c, chunk: int):
    """The kernel on contiguous CUDA tensors in the model layout."""
    global launches
    _check_shapes(x, dt, a, b, c)
    ts = (x, dt, a, b, c)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise TypeError("mamba_scan: x, dt, a, b and c must be on one CUDA "
                        "device")
    if (x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype
            or dt.dtype != torch.float32 or a.dtype != torch.float32):
        raise TypeError(f"mamba_scan: dtypes {[t.dtype for t in ts]}; need "
                        "x, b, c float32 or bfloat16 alike, dt and a "
                        "float32")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("mamba_scan: x, dt, a, b and c must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "mamba_scan: the kernel has no backward yet (ROADMAP, 'The "
            "port: slices': training of the MoE and hybrid families)")
    bs, length, h, p = x.shape
    n = b.shape[-1]
    q = chunk_len(length, chunk)
    if not (bs > 0 and h > 0 and p > 0 and 0 < n <= MAX_STATE
            and q <= MAX_CHUNK):
        raise ValueError(f"mamba_scan: B {bs}, H {h}, P {p}, N {n}, chunk "
                         f"{q}; need N <= {MAX_STATE} and chunk <= "
                         f"{MAX_CHUNK}")
    y = torch.empty_like(x)
    s_fin = torch.empty((bs, h, p, n), dtype=torch.float32, device=x.device)
    handle = lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = handle.ms_ssd(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                            b.data_ptr(), c.data_ptr(), y.data_ptr(),
                            s_fin.data_ptr(), bs, length, h, p, n, q,
                            _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan: CUDA error {err} at launch")
    launches += 1
    return y, s_fin


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, *, chunk: int = 64):
    """Model layout: x (B,L,H,P), dt (B,L,H), a (H,), b/c (B,L,N).

    Returns y (B,L,H,P) in x's dtype and the final state (B,H,P,N) f32:
    the kernel on CUDA tensors, the plain version on CPU ones."""
    _check_shapes(x, dt, a, b, c)
    if x.is_cuda:
        return _launch(x.contiguous(), dt.float().contiguous(),
                       a.float().contiguous(), b.contiguous(),
                       c.contiguous(), chunk)
    return ssd_chunked(x, dt, a, b, c, chunk)
