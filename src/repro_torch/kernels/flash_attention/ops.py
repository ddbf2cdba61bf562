"""Public wrapper of the flash_attention kernels (forward and backward).

Accepts model-layout tensors (B, S, H, hd) / (B, S, KV, hd), transposes to
the kernels' (B, H, S, hd) layout and pads the head dim as the JAX
package's wrapper does (hd > 64: a multiple of 128, else a multiple of 64;
zamba2's hd=80 pads to 128).  The softmax scale is that of the unpadded
head dim.  The transposes and the padding are autograd ops, so a gradient
comes back through them: the padded columns of dq/dk/dv are sliced off.

A CUDA tensor goes to the hand-written kernels, or the call raises; a CPU
tensor goes to the plain version (``ref.attention_ref``), whose autograd
is the gradient.  There is no fallback from one to the other.  When a
gradient is wanted, the forward kernel also writes the per-row log-sum-exp
(and, for bf16, its output in f32 before the rounding) and a
``torch.autograd.Function`` runs the backward kernel
(``csrc/flash_attention_bwd.cu``); serving (no gradient) skips both.
``launches`` counts forward launches, ``bwd_launches`` backward ones.
A tensor that holds no data and stands for the card's
(``kernels.analysis``) takes the kernels' route up to the launch, and is
counted by ``work`` / ``bwd_work`` in place of it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import analysis
from repro_torch.kernels.flash_attention import ref as _ref

launches = 0            # forward kernel launches since the last reset
bwd_launches = 0        # backward kernel launches since the last reset

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CSRC = Path(__file__).resolve().parent / "csrc"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o, o32, lse; B, H, KV, S, hd; scale, causal, window, dtype,
# stream
_FWD_SIG = {"fa_forward": [_P] * 6 + [_I] * 5 + [_F, _I, _I, _I, _P]}
# q, k, v, o, dO, lse, D, dq, dk, dv; B, H, KV, S, hd; scale, causal,
# window, dtype, stream
_BWD_SIG = {"fa_backward": [_P] * 10 + [_I] * 5 + [_F, _I, _I, _I, _P]}


def reset_launches() -> None:
    global launches, bwd_launches
    launches = 0
    bwd_launches = 0


def work(b: int, h: int, kv: int, s: int, hd: int, causal: bool,
         window: int, esize: int) -> tuple:
    """(flops, bytes) of the forward on (B,H,S,hd) q over (B,KV,S,hd) k, v
    of ``esize``-byte elements: 4 hd operations per scored pair and head;
    q, k, v read once and the output written once."""
    flops = 4.0 * b * h * analysis.pairs(s, causal, window) * hd
    return flops, (2 * b * h * s * hd + 2 * b * kv * s * hd) * esize


def bwd_work(b: int, h: int, kv: int, s: int, hd: int, causal: bool,
             window: int, esize: int) -> tuple:
    """(flops, bytes) of the backward: 10 hd operations per scored pair
    and head (S, dP, dV, dQ, dK); q, k, v, o, dO read and dq, dk, dv
    written once in ``esize`` bytes, the f32 lse read once."""
    flops = 10.0 * b * h * analysis.pairs(s, causal, window) * hd
    return flops, ((4 * b * h * s * hd + 4 * b * kv * s * hd) * esize
                   + 4 * b * h * s)


def fwd_lib():
    from repro_torch.kernels import _build
    return _build.load("flash_attention", _CSRC / "flash_attention.cu",
                       _FWD_SIG)


def bwd_lib():
    from repro_torch.kernels import _build
    return _build.load("flash_attention_bwd",
                       _CSRC / "flash_attention_bwd.cu", _BWD_SIG)


def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if not analysis.on_card(t) or t.device != like.device:
        raise ValueError(f"flash_attention: {name} must be on "
                         f"{like.device}, got {t.device}")
    if t.dtype != like.dtype or t.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: {name} dtype {t.dtype}; "
                        "need float32 or bfloat16, all alike")
    if not t.is_contiguous() or (not analysis.traced(t)
                                 and t.data_ptr() % 16):
        raise ValueError(f"flash_attention: {name} must be contiguous "
                         "and 16-byte aligned")


def _check_shapes(qt, kt, vt, window):
    b, h, s, hd = qt.shape
    kv = kt.shape[1]
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


def _launch(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor, *,
            causal: bool, window: int, scale: float, with_lse: bool = False):
    """Run the forward kernel on (B,H,S,hd) tensors.  Returns the output
    (B,H,S,hd), and with ``with_lse`` (out, lse, o32): also the (B,H,S) f32
    log-sum-exp and the output in f32 before its rounding (``out`` itself
    for f32), which the backward kernel takes."""
    global launches
    for name, t in (("q", qt), ("k", kt), ("v", vt)):
        _check(name, t, qt)
    _check_shapes(qt, kt, vt, window)
    b, h, s, hd = qt.shape
    out = torch.empty_like(qt)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=qt.device)
           if with_lse else None)
    o32 = (torch.empty(out.shape, dtype=torch.float32, device=qt.device)
           if with_lse and qt.dtype != torch.float32 else None)
    if analysis.traced(qt):
        analysis.record("flash_attention",
                        work(b, h, kt.shape[1], s, hd, causal, window,
                             qt.element_size()),
                        (qt, kt, vt), [t for t in (out, o32, lse)
                                       if t is not None])
        return (out, lse, out if o32 is None else o32) if with_lse else out
    lib = fwd_lib()
    stream = torch.cuda.current_stream(qt.device).cuda_stream
    with torch.cuda.device(qt.device):
        err = lib.fa_forward(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(),
            o32.data_ptr() if o32 is not None else None,
            lse.data_ptr() if with_lse else None, b, h, kt.shape[1], s, hd,
            float(scale), int(bool(causal)), int(window), _DTYPES[qt.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA error {err} at launch")
    launches += 1
    if not with_lse:
        return out
    return out, lse, out if o32 is None else o32


def _launch_bwd(qt, kt, vt, o32, lse, dout, *, causal: bool, window: int,
                scale: float):
    """Run the backward kernel on the forward's f32 output ``o32`` and
    log-sum-exp (``_launch(..., with_lse=True)``); returns (dq, dk, dv) in
    the kernel layout."""
    global bwd_launches
    for name, t in (("q", qt), ("k", kt), ("v", vt), ("do", dout)):
        _check(name, t, qt)
    _check_shapes(qt, kt, vt, window)
    if o32.shape != qt.shape or dout.shape != qt.shape:
        raise ValueError("flash_attention: o and do must have q's shape")
    if (o32.dtype != torch.float32 or not o32.is_contiguous()
            or o32.device != qt.device):
        raise ValueError("flash_attention: o must be the forward's "
                         "contiguous f32 output on q's device")
    b, h, s, hd = qt.shape
    if (lse.dtype != torch.float32 or lse.shape != (b, h, s)
            or not lse.is_contiguous() or lse.device != qt.device):
        raise ValueError("flash_attention: lse must be contiguous (B,H,S) "
                         "f32 on q's device")
    dq = torch.empty_like(qt)
    dk = torch.empty_like(kt)
    dv = torch.empty_like(vt)
    scratch = torch.empty((b, h, s), dtype=torch.float32, device=qt.device)
    if analysis.traced(qt):
        analysis.record("flash_attention_bwd",
                        bwd_work(b, h, kt.shape[1], s, hd, causal, window,
                                 qt.element_size()),
                        (qt, kt, vt, o32, lse, dout), (dq, dk, dv))
        return dq, dk, dv
    lib = bwd_lib()
    stream = torch.cuda.current_stream(qt.device).cuda_stream
    with torch.cuda.device(qt.device):
        err = lib.fa_backward(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), o32.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, kt.shape[1],
            s, hd, float(scale), int(bool(causal)), int(window),
            _DTYPES[qt.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA error {err} at backward "
                           "launch")
    bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel (with the log-sum-exp) and its backward kernel."""

    @staticmethod
    def forward(ctx, qt, kt, vt, causal, window, scale):
        out, lse, o32 = _launch(qt, kt, vt, causal=causal, window=window,
                                scale=scale, with_lse=True)
        ctx.save_for_backward(qt, kt, vt, o32, lse)
        ctx.opts = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        qt, kt, vt, o32, lse = ctx.saved_tensors
        causal, window, scale = ctx.opts
        dq, dk, dv = _launch_bwd(qt, kt, vt, o32, lse, dout.contiguous(),
                                 causal=causal, window=window, scale=scale)
        return dq, dk, dv, None, None, None


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
    if not analysis.on_card(q):
        out = _ref.attention_ref(qt, kt, vt, causal=causal, window=window,
                                 scale=scale)
    elif torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out = _FlashAttention.apply(qt.contiguous(), kt.contiguous(),
                                    vt.contiguous(), causal, window, scale)
    else:
        out = _launch(qt.contiguous(), kt.contiguous(), vt.contiguous(),
                      causal=causal, window=window, scale=scale)
    if pad:
        out = out[..., :hd]
    return out.transpose(1, 2)
