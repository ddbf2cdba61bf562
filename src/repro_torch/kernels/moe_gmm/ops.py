"""Wrapper of the moe_gmm kernel: the fused expert FFN over
capacity-dispatched MoE inputs (PyTorch port of
``repro.kernels.moe_gmm.ops``).

``expert_ffn`` takes the model layout (G, E, C, d) and reshapes it to the
kernel's (E, G·C, d), experts outermost, as the JAX wrapper does.  A CUDA
tensor goes to the hand-written kernel (``csrc/moe_gmm.cu``) or the call
raises; a CPU tensor goes to the plain version (``ref.expert_ffn_ref``).
There is no fallback from one to the other.  Where an input wants a
gradient, the CUDA route is a ``torch.autograd.Function`` whose backward
launches the hand-written backward (``csrc/moe_gmm_bwd.cu``); on the CPU
autograd runs through the plain version.  ``launches`` counts calls of the
forward kernel route: for bf16 one call is two CUDA launches (the gate-up
kernel, which writes h as a bf16 pair into a workspace this wrapper
allocates, then the down kernel), for f32 one.  ``bwd_launches`` counts
calls of the backward, three CUDA launches each (gate-up with dh, dx, the
weight gradients), and ``bwd_design_launches`` the same calls by the
backward's design (``bwd_design``): "wgmma" (bf16 that TMA can describe),
"mma.sync" (other bf16 shapes), "fma" (f32 on the CUDA cores).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.moe_gmm.ref import expert_ffn_ref

launches = 0            # forward kernel-route calls since the last reset
bwd_launches = 0        # backward kernel-route calls since the last reset
BWD_DESIGNS = ("wgmma", "mma.sync", "fma")
bwd_design_launches = dict.fromkeys(BWD_DESIGNS, 0)     # the same, by design

ACTS = ("silu", "gelu")
MAX_GRID_YZ = 65535     # CUDA's limit on a grid's y and z
# bf16 (two kernels on the tensor cores): each kernel's block tile (BM,
# BN), for M <= SMALL_M rows per expert (decode) and above (prefill)
SMALL_M = 16
TILES = {"decode": {"gate_up": (16, 64), "down": (16, 64)},
         "prefill": {"gate_up": (128, 64), "down": (64, 256)}}
HCOLS = 64              # the workspace's rows: ff rounded up to this
# f32 (the CUDA-core kernel)
BM_F32 = 32             # token rows per block
SLAB = 1024             # widest slab of y's columns one block accumulates
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gmm.cu"
_BWD_SOURCE = _SOURCE.parent / "moe_gmm_bwd.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w1, w3, w2, h (workspace), y; E, M, d, ff; act, dtype, stream
_SIG = {"mg_ffn": [_P] * 6 + [_I] * 4 + [_I, _I, _P]}
# x, w1, w3, w2, dy, workspace, dx, dw1, dw3, dw2; E, M, d, ff; act,
# dtype, design, stream
_BWD_SIG = {"mg_ffn_bwd": [_P] * 10 + [_I] * 4 + [_I, _I, _I, _P]}


def reset_launches() -> None:
    global launches, bwd_launches
    launches = 0
    bwd_launches = 0
    for name in BWD_DESIGNS:
        bwd_design_launches[name] = 0


def lib():
    from repro_torch.kernels import _build
    return _build.load("moe_gmm", _SOURCE, _SIG)


def bwd_lib():
    from repro_torch.kernels import _build
    return _build.load("moe_gmm_bwd", _BWD_SOURCE, _BWD_SIG)


def _check(x, w1, w2, w3, act):
    if act not in ACTS:
        raise ValueError(f"moe_gmm: act {act!r} not in {ACTS}")
    if x.dim() != 3:
        raise ValueError(f"moe_gmm: x must be (E, M, d), got "
                         f"{tuple(x.shape)}")
    e, _, d = x.shape
    ff = w1.shape[-1]
    if (w1.shape != (e, d, ff) or w3.shape != (e, d, ff)
            or w2.shape != (e, ff, d)):
        raise ValueError(f"moe_gmm: shapes x {tuple(x.shape)} w1 "
                         f"{tuple(w1.shape)} w3 {tuple(w3.shape)} w2 "
                         f"{tuple(w2.shape)}")


def tiles(m: int) -> dict:
    """The bf16 kernels' block tiles for M rows per expert."""
    return TILES["decode" if m <= SMALL_M else "prefill"]


def workspace_shape(e: int, m: int, ff: int) -> tuple:
    """The bf16 workspace: h as a bf16 pair (hi, lo) of (E, M, ldh)
    planes, ldh = ff rounded up to whole HCOLS."""
    return 2, e, m, -(-ff // HCOLS) * HCOLS


def bwd_workspace_shape(e: int, m: int, ff: int,
                        dtype: torch.dtype = torch.bfloat16) -> tuple:
    """The backward's workspace: planes of (E, M, ldh), ldh = ff rounded
    up to whole HCOLS: h_hi, h_lo, dg, du in bf16; h, dg, du in f32."""
    return (4 if dtype == torch.bfloat16 else 3, e, m,
            -(-ff // HCOLS) * HCOLS)


def bwd_design(e: int, m: int, d: int, ff: int, dtype: torch.dtype,
               aligned: bool = True) -> str:
    """The backward's design for x (E, M, d), an expert ff and the dtype:
    "fma" for f32; for bf16 "wgmma" where TMA can describe every operand
    (d and ff multiples of 8, so rows are whole 16 bytes, and every
    pointer 16-byte aligned: ``aligned``), else "mma.sync".  Pure: the C
    entry takes the same rule and refuses a call that names another."""
    if not (e > 0 and m > 0 and ff > 0 and d > 0):
        raise ValueError(f"moe_gmm: E {e}, M {m}, ff {ff}, d {d}; need "
                         "all > 0")
    if dtype not in _DTYPES:
        raise TypeError(f"moe_gmm: dtype {dtype}; need float32 or "
                        "bfloat16")
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if d % 8 == 0 and ff % 8 == 0 and aligned else "mma.sync"


def launch_grid(e: int, m: int, d: int, ff: int,
                dtype: torch.dtype = torch.bfloat16) -> tuple:
    """The kernel route's grids, one per launch, for x (E, M, d) and an
    expert ff: bf16 ((M-tiles, ff-tiles, E) of the gate-up kernel,
    (M-tiles, d-tiles, E) of the down kernel); f32 ((M-tiles, E, slabs of
    y's columns),).  Raises ValueError on what they do not take.  Pure:
    the shape rules need no card."""
    if not (e > 0 and m > 0 and ff > 0 and d > 0):
        raise ValueError(f"moe_gmm: E {e}, M {m}, ff {ff}, d {d}; need "
                         "all > 0")
    if dtype == torch.float32:
        slabs = -(-d // SLAB)
        if e > MAX_GRID_YZ or slabs > MAX_GRID_YZ:
            raise ValueError(f"moe_gmm: E {e} and {slabs} slabs of d {d} "
                             f"must each be at most {MAX_GRID_YZ}")
        return ((-(-m // BM_F32), e, slabs),)
    t = tiles(m)
    (gbm, gbn), (dbm, dbn) = t["gate_up"], t["down"]
    f_tiles, n_tiles = -(-ff // gbn), -(-d // dbn)
    if max(e, f_tiles, n_tiles) > MAX_GRID_YZ:
        raise ValueError(f"moe_gmm: E {e}, {f_tiles} tiles of ff {ff} and "
                         f"{n_tiles} of d {d} must each be at most "
                         f"{MAX_GRID_YZ}")
    return (-(-m // gbm), f_tiles, e), (-(-m // dbm), n_tiles, e)


def _check_cuda(ts) -> None:
    """Every tensor of ``ts`` on x's CUDA device, of x's dtype (f32 or
    bf16), contiguous; x is ``ts[0]``."""
    x = ts[0]
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise TypeError("moe_gmm: x, w1, w2, w3 (and dy) must be on one "
                        "CUDA device")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in ts):
        raise TypeError(f"moe_gmm: dtypes {[t.dtype for t in ts]}; need "
                        "float32 or bfloat16, all alike")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("moe_gmm: x, w1, w2, w3 (and dy) must be "
                         "contiguous")


def _launch(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
            w3: torch.Tensor, act: str) -> torch.Tensor:
    """The kernel on contiguous CUDA tensors x (E, M, d), w1/w3 (E, d, ff),
    w2 (E, ff, d) of one dtype -> y (E, M, d)."""
    global launches
    _check(x, w1, w2, w3, act)
    _check_cuda((x, w1, w2, w3))
    e, m, d = x.shape
    ff = w1.shape[-1]
    launch_grid(e, m, d, ff, x.dtype)
    y = torch.empty_like(x)
    h = (torch.empty(workspace_shape(e, m, ff), dtype=x.dtype,
                     device=x.device) if x.dtype == torch.bfloat16 else None)
    handle = lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = handle.mg_ffn(x.data_ptr(), w1.data_ptr(), w3.data_ptr(),
                            w2.data_ptr(), None if h is None else h.data_ptr(),
                            y.data_ptr(), e, m, d, ff, ACTS.index(act),
                            _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm: CUDA error {err} at launch")
    launches += 1
    return y


def _launch_bwd(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                w3: torch.Tensor, dy: torch.Tensor, act: str) -> tuple:
    """The backward kernel on contiguous CUDA tensors (those of ``_launch``
    and dy (E, M, d), y's gradient) -> (dx, dw1, dw2, dw3) in their
    dtype; with gelu dw3 is 0 (w3 is unused)."""
    global bwd_launches
    _check(x, w1, w2, w3, act)
    if dy.shape != x.shape:
        raise ValueError(f"moe_gmm: dy {tuple(dy.shape)} is not x's shape "
                         f"{tuple(x.shape)}")
    _check_cuda((x, w1, w2, w3, dy))
    e, m, d = x.shape
    ff = w1.shape[-1]
    launch_grid(e, m, d, ff, x.dtype)
    dx, dw1, dw2 = (torch.empty_like(t) for t in (x, w1, w2))
    dw3 = torch.empty_like(w3) if act == "silu" else torch.zeros_like(w3)
    ws = torch.empty(bwd_workspace_shape(e, m, ff, x.dtype), dtype=x.dtype,
                     device=x.device)
    ptrs = [t.data_ptr() for t in (x, w1, w3, w2, dy, ws, dx, dw1, dw3, dw2)]
    design = bwd_design(e, m, d, ff, x.dtype,
                        aligned=all(p % 16 == 0 for p in ptrs))
    handle = bwd_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = handle.mg_ffn_bwd(*ptrs, e, m, d, ff, ACTS.index(act),
                                _DTYPES[x.dtype], BWD_DESIGNS.index(design),
                                stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm: CUDA error {err} at the backward's "
                           f"launch ({design})")
    bwd_launches += 1
    bwd_design_launches[design] += 1
    return dx, dw1, dw2, dw3


class _ExpertFFN(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, w1, w2, w3, act):
        ctx.save_for_backward(x, w1, w2, w3)
        ctx.act = act
        return _launch(x, w1, w2, w3, act)

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2, w3 = ctx.saved_tensors
        return (*_launch_bwd(x, w1, w2, w3, dy.contiguous(), ctx.act), None)


def expert_ffn_kernel_layout(x: torch.Tensor, w1: torch.Tensor,
                             w2: torch.Tensor, w3: torch.Tensor, *,
                             act: str = "silu") -> torch.Tensor:
    """x: (E, M, d) -> (E, M, d): the kernel on CUDA tensors (its backward
    too where an input wants a gradient), the plain version on CPU ones
    (the JAX package's ``kernel.expert_ffn``)."""
    _check(x, w1, w2, w3, act)
    if x.is_cuda:
        ts = tuple(t.contiguous() for t in (x, w1, w2, w3))
        if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
            return _ExpertFFN.apply(*ts, act)
        return _launch(*ts, act)
    return expert_ffn_ref(x, w1, w2, w3, act=act)


def expert_ffn(xe: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
               w3: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """xe: (G, E, C, d) dispatched tokens -> (G, E, C, d)."""
    g, e, c, d = xe.shape
    x = xe.transpose(0, 1).reshape(e, g * c, d)
    y = expert_ffn_kernel_layout(x, w1, w2, w3, act=act)
    return y.reshape(e, g, c, d).transpose(0, 1)
