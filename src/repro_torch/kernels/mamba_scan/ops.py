"""Wrapper of the mamba_scan kernel: the Mamba2 SSD chunked scan in the
model's call signature (PyTorch port of ``repro.kernels.mamba_scan.ops``),
and its backward.

``ssd`` takes the model layout (x (B,L,H,P), dt (B,L,H), a (H,), b/c
(B,L,N)) and returns y (B,L,H,P) and the final state (B,H,P,N) f32, like
``models.ssm.ssd_chunked``.  The kernel reads and writes that layout
itself, so no transpose is made.  A CUDA tensor goes to the hand-written
kernel (``csrc/mamba_scan.cu``) or the call raises; a CPU tensor goes to
the plain version (``ref.ssd_chunked``, under autograd where an input
wants a gradient).  There is no fallback from one to the other.  Where an
input wants a gradient on CUDA, the call goes through ``_SSD``, whose
backward is the kernel ``csrc/mamba_scan_bwd.cu`` (P <= 64).
``launches`` counts forward kernel launches (one per call: bf16's two
passes run in one C call), ``bwd_launches`` backward ones (one per call:
its passes run in one C call), and ``bwd_design_launches`` the same calls
by the backward's route (``bwd_design``): "mma.sync" (bf16, chunk-parallel
on the tensor cores) or "fma" (f32, the walk on the CUDA cores).  A tensor that holds no data and stands for the
card's (``kernels.analysis``) takes the kernel route up to the launch,
and is counted by ``work`` / ``bwd_work`` in place of it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import analysis
from repro_torch.kernels.mamba_scan.ref import chunk_len, ssd_chunked

launches = 0            # forward kernel launches since the last reset
bwd_launches = 0        # backward kernel launches since the last reset
BWD_DESIGNS = ("mma.sync", "fma")
bwd_design_launches = dict.fromkeys(BWD_DESIGNS, 0)     # the same, by route

MAX_CHUNK = 64          # longest chunk a block's shared tiles hold
MAX_STATE = 64          # largest state dimension N
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BWD_HEAD = 64       # largest P the backward's tiles hold
_SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
_BWD_SOURCE = _SOURCE.with_name("mamba_scan_bwd.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, dt, a, b, c, y, s_fin, scratch; B, L, H, P, N, chunk; dtype, stream
_SIG = {"ms_ssd": [_P] * 8 + [_I] * 6 + [_I, _P]}
# x, dt, a, b, c, dy, ds_fin, dx, ddt, da, db, dc, scratch; B, L, H, P, N,
# chunk; dtype, stream
_BWD_SIG = {"msb_ssd_bwd": [_P] * 13 + [_I] * 6 + [_I, _P]}


def reset_launches() -> None:
    global launches, bwd_launches
    launches = 0
    bwd_launches = 0
    for name in BWD_DESIGNS:
        bwd_design_launches[name] = 0


def bwd_design(dtype: torch.dtype) -> str:
    """The backward's route for x's dtype: "mma.sync" for bf16, "fma" for
    f32 (the C entry picks the same by its dtype)."""
    return "mma.sync" if dtype == torch.bfloat16 else "fma"


def work(b: int, length: int, h: int, p: int, n: int, q: int,
         esize: int) -> tuple:
    """(flops, bytes) of the chunked scan on x (B,L,H,P) and b, c (B,L,N)
    of ``esize``-byte elements in chunks of q: C B^T once per (batch,
    chunk) over the causal pairs, the masked (q x q) product per head, and
    the y_inter and state products per head; x, b, c and the f32 dt, a
    read once, y and the f32 final state written once."""
    nc = length // q
    pairs = q * (q + 1) // 2
    flops = 2.0 * b * nc * pairs * n \
        + 2.0 * b * h * nc * (pairs * p + 2 * q * n * p)
    return flops, ((2 * b * length * h * p + 2 * b * length * n) * esize
                   + 4 * (b * length * h + h + b * h * p * n))


def bwd_work(b: int, length: int, h: int, p: int, n: int, q: int,
             esize: int) -> tuple:
    """(flops, bytes) of the scan's backward: per (batch, chunk) C B^T
    over the causal pairs, and per head dY X^T, M1^T dY over the pairs and
    M2^T C, M2 B over the pairs, and the four q P N products of the state
    (dS B, X dS, dY S_in, the dS update); x, dy, b, c, dt and a read once,
    dx, db, dc, ddt and da written once."""
    nc = length // q
    pairs = q * (q + 1) // 2
    flops = 2.0 * b * nc * pairs * n \
        + 2.0 * b * h * nc * (2 * pairs * p + 2 * pairs * n + 4 * q * p * n)
    return flops, ((3 * b * length * h * p + 4 * b * length * n) * esize
                   + 4 * 2 * (b * length * h + h))


def lib():
    from repro_torch.kernels import _build
    return _build.load("mamba_scan", _SOURCE, _SIG)


def bwd_lib():
    from repro_torch.kernels import _build
    return _build.load("mamba_scan_bwd", _BWD_SOURCE, _BWD_SIG)


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


def _outputs(x, b, q: int):
    """y, the f32 final state and, for bf16, the f32 scratch of a call."""
    bs, length, h, p = x.shape
    y = torch.empty_like(x)
    s_fin = torch.empty((bs, h, p, b.shape[-1]), dtype=torch.float32,
                        device=x.device)
    scratch = None
    if x.dtype == torch.bfloat16:
        scratch = torch.empty(scratch_floats(bs, length, h, q),
                              dtype=torch.float32, device=x.device)
    return y, s_fin, scratch


def scratch_floats(bs: int, length: int, h: int, q: int) -> int:
    """f32 scratch of the bf16 route (``csrc/mamba_scan.cu``,
    ``launch_bf16``): C B^T (B, L/q, 64, 64) and cum (B, L/q, H, 64)."""
    return bs * (length // q) * 64 * (64 + h)


def call(handle, x, dt, a, b, c, q: int, stream):
    """``handle.ms_ssd`` on checked, contiguous tensors of one device, with
    the outputs and, for bf16, the scratch allocated there: (its return
    code, y, the final state)."""
    y, s_fin, scratch = _outputs(x, b, q)
    bs, length, h, p = x.shape
    n = b.shape[-1]
    err = handle.ms_ssd(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                        b.data_ptr(), c.data_ptr(), y.data_ptr(),
                        s_fin.data_ptr(), None if scratch is None
                        else scratch.data_ptr(), bs, length, h, p, n, q,
                        _DTYPES[x.dtype], stream)
    return err, y, s_fin


def bwd_scratch_floats(bs: int, length: int, h: int, p: int, n: int,
                       q: int) -> int:
    """f32 scratch of the backward (``csrc/mamba_scan_bwd.cu``, ``layout``):
    cum (B, L/q, H, 64) and C B^T (B, L/q, 64, 64), the state entering
    each chunk and the gradient of the state leaving it (B, H, L/q, P, N)
    each, each head's db and dc (B, H, L, N) each and da's partials (B, H,
    L/q)."""
    nc = length // q
    return (bs * nc * 64 * (h + 64)
            + bs * h * (2 * nc * p * n + 2 * length * n + nc))


def _bwd_outputs(x, dt, a, b, c, q: int):
    """(dx, ddt, da, db, dc) and the f32 scratch of a backward call."""
    bs, length, h, p = x.shape
    grads = tuple(torch.empty_like(t) for t in (x, dt, a, b, c))
    scratch = torch.empty(bwd_scratch_floats(bs, length, h, p, b.shape[-1],
                                             q),
                          dtype=torch.float32, device=x.device)
    return grads, scratch


def call_bwd(handle, x, dt, a, b, c, dy, ds_fin, q: int, stream):
    """``handle.msb_ssd_bwd`` on checked, contiguous tensors of one device
    (``ds_fin`` may be None: a zero gradient of the final state), with the
    gradients and the scratch allocated there: (its return code, (dx,
    ddt, da, db, dc))."""
    bs, length, h, p = x.shape
    n = b.shape[-1]
    (dx, ddt, da, db, dc), scratch = _bwd_outputs(x, dt, a, b, c, q)
    err = handle.msb_ssd_bwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), dy.data_ptr(),
        None if ds_fin is None else ds_fin.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
        scratch.data_ptr(), bs, length, h, p, n, q, _DTYPES[x.dtype], stream)
    return err, (dx, ddt, da, db, dc)


def _check_cuda(x, dt, a, b, c):
    ts = (x, dt, a, b, c)
    if not all(analysis.on_card(t) and t.device == x.device for t in ts):
        raise TypeError("mamba_scan: x, dt, a, b and c must be on one CUDA "
                        "device")
    if (x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype
            or dt.dtype != torch.float32 or a.dtype != torch.float32):
        raise TypeError(f"mamba_scan: dtypes {[t.dtype for t in ts]}; need "
                        "x, b, c float32 or bfloat16 alike, dt and a "
                        "float32")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("mamba_scan: x, dt, a, b and c must be contiguous")


def _launch(x, dt, a, b, c, chunk: int):
    """The kernel on contiguous CUDA tensors in the model layout."""
    global launches
    _check_shapes(x, dt, a, b, c)
    _check_cuda(x, dt, a, b, c)
    bs, length, h, p = x.shape
    n = b.shape[-1]
    q = chunk_len(length, chunk)
    if not (bs > 0 and h > 0 and p > 0 and 0 < n <= MAX_STATE
            and q <= MAX_CHUNK):
        raise ValueError(f"mamba_scan: B {bs}, H {h}, P {p}, N {n}, chunk "
                         f"{q}; need N <= {MAX_STATE} and chunk <= "
                         f"{MAX_CHUNK}")
    if analysis.traced(x):
        y, s_fin, _ = _outputs(x, b, q)
        analysis.record("mamba_scan",
                        work(bs, length, h, p, n, q, x.element_size()),
                        (x, dt, a, b, c), (y, s_fin))
        return y, s_fin
    handle = lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err, y, s_fin = call(handle, x, dt, a, b, c, q, stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan: CUDA error {err} at launch")
    launches += 1
    return y, s_fin


def _launch_bwd(x, dt, a, b, c, dy, ds_fin, chunk: int):
    """The backward kernel on contiguous CUDA tensors in the model layout:
    (dx, ddt, da, db, dc) given dy (x's dtype) and ds_fin ((B,H,P,N) f32,
    or None for 0)."""
    global bwd_launches
    _check_shapes(x, dt, a, b, c)
    _check_cuda(x, dt, a, b, c)
    bs, length, h, p = x.shape
    n = b.shape[-1]
    q = chunk_len(length, chunk)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError(f"mamba_scan: dy {tuple(dy.shape)} {dy.dtype}; "
                         f"need x's shape and dtype, contiguous")
    if ds_fin is not None and (ds_fin.shape != (bs, h, p, n)
                               or ds_fin.dtype != torch.float32
                               or not ds_fin.is_contiguous()):
        raise ValueError(f"mamba_scan: ds_fin {tuple(ds_fin.shape)} "
                         f"{ds_fin.dtype}; need ({bs}, {h}, {p}, {n}) "
                         "float32, contiguous")
    if not (0 < p <= MAX_BWD_HEAD and 0 < n <= MAX_STATE
            and q <= MAX_CHUNK):
        raise ValueError(f"mamba_scan: backward of P {p}, N {n}, chunk {q}; "
                         f"need P <= {MAX_BWD_HEAD}, N <= {MAX_STATE} and "
                         f"chunk <= {MAX_CHUNK}")
    if analysis.traced(x):
        grads, _ = _bwd_outputs(x, dt, a, b, c, q)
        analysis.record("mamba_scan_bwd",
                        bwd_work(bs, length, h, p, n, q, x.element_size()),
                        (x, dt, a, b, c, dy), grads)
        return grads
    handle = bwd_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err, grads = call_bwd(handle, x, dt, a, b, c, dy, ds_fin, q, stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan: CUDA error {err} at backward "
                           "launch")
    bwd_launches += 1
    bwd_design_launches[bwd_design(x.dtype)] += 1
    return grads


class _SSD(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient.
    Nothing beyond the inputs is kept: the backward rebuilds the states
    entering the chunks.  A gradient that does not reach the final state
    arrives as None (``set_materialize_grads(False)``) and is 0."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk):
        ctx.save_for_backward(x, dt, a, b, c)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _launch(x, dt, a, b, c, chunk)

    @staticmethod
    def backward(ctx, dy, ds_fin):
        x, dt, a, b, c = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = _launch_bwd(x, dt, a, b, c, dy.contiguous(),
                            None if ds_fin is None else ds_fin.contiguous(),
                            ctx.chunk)
        return (*grads, None)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, *, chunk: int = 64):
    """Model layout: x (B,L,H,P), dt (B,L,H), a (H,), b/c (B,L,N).

    Returns y (B,L,H,P) in x's dtype and the final state (B,H,P,N) f32:
    the kernel on CUDA tensors (with the backward kernel as its gradient
    where an input wants one), the plain version on CPU ones."""
    _check_shapes(x, dt, a, b, c)
    if analysis.on_card(x):
        ts = (x.contiguous(), dt.float().contiguous(),
              a.float().contiguous(), b.contiguous(), c.contiguous())
        if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
            return _SSD.apply(*ts, chunk)
        return _launch(*ts, chunk)
    return ssd_chunked(x, dt, a, b, c, chunk)
