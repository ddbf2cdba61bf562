"""Public wrapper of the flash_attention kernel.

Accepts model-layout tensors (B, S, H, hd) / (B, S, KV, hd), transposes to
the kernel's (B, H, S, hd) layout and pads the head dim as the JAX
package's wrapper does (hd > 64: a multiple of 128, else a multiple of 64;
zamba2's hd=80 pads to 128).  The softmax scale is that of the unpadded
head dim.

A CUDA tensor goes to the hand-written kernel, or the call raises; a CPU
tensor goes to the plain version (``ref.attention_ref``).  There is no
fallback from one to the other.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ref as _ref

launches = 0            # kernel launches since import (or the last reset)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    global launches
    launches = 0


def _launch(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor, *,
            causal: bool, window: int, scale: float) -> torch.Tensor:
    """Run the CUDA kernel on (B,H,S,hd) tensors; returns (B,H,S,hd)."""
    global launches
    b, h, s, hd = qt.shape
    kv = kt.shape[1]
    for name, t in (("q", qt), ("k", kt), ("v", vt)):
        if not t.is_cuda or t.device != qt.device:
            raise ValueError(f"flash_attention: {name} must be on "
                             f"{qt.device}, got {t.device}")
        if t.dtype != qt.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"flash_attention: {name} dtype {t.dtype}; "
                            "need float32 or bfloat16, all alike")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             "and 16-byte aligned")
    if kt.shape != (b, kv, s, hd) or vt.shape != kt.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(qt.shape)} "
                         f"k {tuple(kt.shape)} v {tuple(vt.shape)}")
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: {h} heads not a multiple of "
                         f"{kv} kv heads")
    if hd not in (64, 128):
        raise ValueError(f"flash_attention: padded head dim {hd} not in "
                         "(64, 128)")
    if window < 0 or s == 0:
        raise ValueError(f"flash_attention: window {window}, seq {s}")
    from repro_torch.kernels.flash_attention import build
    out = torch.empty_like(qt)
    stream = torch.cuda.current_stream(qt.device).cuda_stream
    with torch.cuda.device(qt.device):
        err = build.lib().fa_forward(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(),
            b, h, kv, s, hd, float(scale), int(bool(causal)), int(window),
            _DTYPES[qt.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA error {err} at launch")
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,S,KV,hd) -> (B,S,H,hd)."""
    hd = q.shape[-1]
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    pad = (-hd) % 128 if hd > 64 else (-hd) % 64
    if pad:
        qt, kt, vt = (torch.nn.functional.pad(x, (0, pad))
                      for x in (qt, kt, vt))
    scale = hd ** -0.5                      # unpadded head dim
    if q.is_cuda:
        out = _launch(qt.contiguous(), kt.contiguous(), vt.contiguous(),
                      causal=causal, window=window, scale=scale)
    else:
        out = _ref.attention_ref(qt, kt, vt, causal=causal, window=window,
                                 scale=scale)
    if pad:
        out = out[..., :hd]
    return out.transpose(1, 2)
