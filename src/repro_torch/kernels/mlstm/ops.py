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
(``ref.mlstm_chunked``, under autograd where an input wants a gradient).
There is no fallback from one to the other.  Where an input wants a
gradient on CUDA, the call goes through ``_MLSTM``, whose backward is the
kernel ``csrc/mlstm_bwd.cu``: from the zero state, with the final
state's gradient 0, as training calls it.  A gradient through an initial
state, or one that reaches the final (c, n, m), raises
``NotImplementedError`` (ROADMAP, queue 1) rather than come out wrong.
``launches`` counts forward kernel launches (one per call: the kernel's
passes, four for float32 and five for bfloat16, run in one C call),
``bwd_launches`` backward ones (one per call: its passes run in one C
call), and ``bwd_design_launches`` the same calls by the backward's route
(``bwd_design``): "mma.sync" (bf16, its products on the tensor cores) or
"fma" (f32, on the CUDA cores).  A tensor that holds no data and stands
for the card's (``kernels.analysis``) takes the kernel route up to the
launch, and is counted by ``work`` / ``bwd_work`` in place of it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import analysis
from repro_torch.kernels.mlstm.ref import mlstm_chunked

launches = 0            # forward kernel launches since the last reset
bwd_launches = 0        # backward kernel launches since the last reset
BWD_DESIGNS = ("mma.sync", "fma")
bwd_design_launches = dict.fromkeys(BWD_DESIGNS, 0)     # the same, by route

MAX_CHUNK = 128         # longest chunk the kernel's shared tiles hold
MAX_HEAD_DIM = 1024     # widest head a block's C tile holds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = Path(__file__).resolve().parent / "csrc" / "mlstm.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, logi, logf, c0, n0, m0, h, c, n, m, gvec, gscal, carry, nin,
# st, cin, den; B, L, H, D, chunk, dtype; stream
_SIG = {"ml_mlstm": [_P] * 19 + [_I] * 6 + [_P]}
_BWD_SOURCE = _SOURCE.with_name("mlstm_bwd.cu")
# q, k, v, logi, logf, dh, dq, dk, dv, dlogi, dlogf, binds, scratch; B, L,
# H, D, chunk, dtype; stream
_BWD_SIG = {"ml_mlstm_bwd": [_P] * 13 + [_I] * 6 + [_P],
            "ml_bwd_scratch_floats": [_I] * 5 + [_P]}
_STATE_GRAD = ("mlstm: the backward kernel runs from the zero state with "
               "a zero gradient of the final state, as training calls it; "
               "a gradient through an initial state or into the final "
               "(c, n, m) is not ported (ROADMAP, queue 1: the mLSTM "
               "state's gradient)")


def reset_launches() -> None:
    global launches, bwd_launches
    launches = 0
    bwd_launches = 0
    for name in BWD_DESIGNS:
        bwd_design_launches[name] = 0


def bwd_design(dtype: torch.dtype) -> str:
    """The backward's route for q's dtype: "mma.sync" for bf16, "fma" for
    f32 (the C entry picks the same by its dtype)."""
    return "mma.sync" if dtype == torch.bfloat16 else "fma"


def work(b: int, length: int, h: int, hd: int, q: int, state: bool,
         esize: int) -> tuple:
    """(flops, bytes) of the chunked mLSTM on q, k, v (B,L,H,hd) of
    ``esize``-byte elements in chunks of q: per (b, h) and chunk of c
    tokens, S and S V over the c (c + 1) / 2 causal pairs, Q C^T and the
    C update over c hd^2 (Q C^T and q . n not in the first chunk when the
    state is zero), the n update and q . n over c hd.  q, k, v and the
    f32 gates read once, h and the f32 final state written once, an
    initial state read once."""
    flops = 0.0
    for ci, l0 in enumerate(range(0, length, q)):
        c = min(q, length - l0)
        inter = 1 if (state or ci > 0) else 0
        flops += 4.0 * hd * c * (c + 1) / 2 + 2.0 * c * hd * hd * (1 + inter) \
            + 2.0 * c * hd * (1 + inter)
    return flops * b * h, (4 * b * length * h * hd * esize
                           + 2 * 4 * b * length * h
                           + 4 * b * h * (hd * hd + hd + 1)
                           * (2 if state else 1))


def bwd_work(b: int, length: int, h: int, hd: int, q: int,
             esize: int) -> tuple:
    """(flops, bytes) of the backward from the zero state: per (b, h) and
    chunk of c tokens, Q K^T, dH V^T, d ds K, d ds^T Q and (s rinv)^T dH
    over the c (c + 1) / 2 causal pairs; the chunk's own dC and C^T dh
    over c hd^2 where a state enters it (not the first chunk); dC k and
    dC^T v over c hd^2 where a gradient leaves it (not the last); the
    states C over c hd^2 (not the last).  q, k, v, dh and the f32 gates
    read once; dq, dk, dv, dlogi and dlogf written once."""
    flops = 0.0
    starts = list(range(0, length, q))
    for ci, l0 in enumerate(starts):
        c = min(q, length - l0)
        first, last = ci == 0, ci == len(starts) - 1
        flops += 5 * 2.0 * hd * c * (c + 1) / 2 \
            + 2.0 * c * hd * hd * ((0 if first else 2) + (0 if last else 3))
    return flops * b * h, (7 * b * length * h * hd * esize
                           + 4 * 4 * b * length * h)


def bwd_scratch_floats(bs: int, length: int, h: int, hd: int,
                       qc: int) -> int:
    """The backward's f32 scratch, as ``ml_bwd_scratch_floats`` of
    ``csrc/mlstm_bwd.cu`` (``layout``) gives it: eleven (B,H,L) vectors,
    carry (B,H,nc), three (B,H,nc,q,q), two (B,H,nc,hd,hd), two
    (B,H,nc,hd), three (B,H,nc,q,hd) and the scan's partials."""
    nc, bh = -(-length // qc), bs * h
    scan_blocks = -(-(hd * hd + hd) // 256)
    return bh * (11 * length + nc + 3 * nc * qc * qc + 2 * nc * hd * hd
                 + 2 * nc * hd + 3 * nc * qc * hd + nc * scan_blocks)


def lib():
    from repro_torch.kernels import _build
    return _build.load("mlstm", _SOURCE, _SIG)


def bwd_lib():
    from repro_torch.kernels import _build
    return _build.load("mlstm_bwd", _BWD_SOURCE, _BWD_SIG)


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


def call(handle, q, k, v, logi, logf, state, qc: int, stream):
    """``handle.ml_mlstm`` on checked, contiguous tensors of one device,
    with the outputs and the scratch allocated there (csrc/mlstm.cu lists
    the layouts): (its return code, h, (c, n, m))."""
    out, (c, n, m), (gvec, gscal, carry, nin, st, cin, den) = _outputs(
        q, qc)
    bs, length, h, hd = q.shape
    c0, n0, m0 = (t.data_ptr() for t in state) if state is not None \
        else (None, None, None)
    err = handle.ml_mlstm(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), logi.data_ptr(),
        logf.data_ptr(), c0, n0, m0, out.data_ptr(), c.data_ptr(),
        n.data_ptr(), m.data_ptr(), gvec.data_ptr(), gscal.data_ptr(),
        carry.data_ptr(), nin.data_ptr(), st.data_ptr(),
        None if cin is None else cin.data_ptr(), den.data_ptr(), bs, length,
        h, hd, qc, _DTYPES[q.dtype], stream)
    return err, out, (c, n, m)


def _outputs(q, qc: int):
    """h, the f32 final state (c, n, m) and the scratch of a call."""
    bs, length, h, hd = q.shape
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    nc = -(-length // qc)
    out = torch.empty_like(q)
    c = torch.empty((bs, h, hd, hd), **f32)
    n = torch.empty((bs, h, hd), **f32)
    m = torch.empty((bs, h), **f32)
    # per (b, h, chunk): the gates' vectors and scalars, carry, the n
    # entering the chunk, S and den; for bf16 S as a bf16 pair and the C
    # entering the chunk as one
    gvec = torch.empty((bs, h, nc, 4, qc), **f32)
    gscal = torch.empty((bs, h, nc, 2), **f32)
    carry = torch.empty((bs, h, nc), **f32)
    nin = torch.empty((bs, h, nc, hd), **f32)
    den = torch.empty((bs, h, nc, qc), **f32)
    cin = None
    if q.dtype == torch.bfloat16:
        sq, dp = -(-qc // 16) * 16, -(-hd // 8) * 8
        st = torch.empty((bs, h, nc, 2, sq, sq), dtype=q.dtype, device=dev)
        cin = torch.empty((bs, h, nc, 2, hd, dp), dtype=q.dtype, device=dev)
    else:
        st = torch.empty((bs, h, nc, qc, qc), **f32)
    return out, (c, n, m), (gvec, gscal, carry, nin, st, cin, den)


def _check_cuda(q, k, v, logi, logf, state, chunk: int) -> int:
    """Raise unless the inputs are contiguous CUDA tensors of one device
    and of the kernel's dtypes and sizes; the chunk the call uses."""
    _check_shapes(q, k, v, logi, logf, state)
    ts = (q, k, v, logi, logf) + tuple(state or ())
    if not all(analysis.on_card(t) and t.device == q.device for t in ts):
        raise TypeError("mlstm: q, k, v, logi, logf and the state must be "
                        "on one CUDA device")
    if (q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype
            or any(t.dtype != torch.float32 for t in ts[3:])):
        raise TypeError(f"mlstm: dtypes {[t.dtype for t in ts]}; need q, "
                        "k, v float32 or bfloat16 alike, the gates and the "
                        "state float32")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("mlstm: inputs must be contiguous")
    bs, length, h, hd = q.shape
    qc = min(chunk, length)
    if not (bs > 0 and h > 0 and 0 < hd <= MAX_HEAD_DIM and hd % 4 == 0
            and 0 < qc <= MAX_CHUNK):
        raise ValueError(f"mlstm: B {bs}, L {length}, H {h}, head dim {hd}, "
                         f"chunk {qc}; need head dim <= {MAX_HEAD_DIM} and "
                         f"a multiple of 4, 0 < chunk <= {MAX_CHUNK}")
    return qc


def _launch(q, k, v, logi, logf, state, chunk: int):
    """The kernel on contiguous CUDA tensors in the model layout."""
    global launches
    qc = _check_cuda(q, k, v, logi, logf, state, chunk)
    if analysis.traced(q):
        out, fin, _ = _outputs(q, qc)
        bs, length, h, hd = q.shape
        analysis.record("mlstm", work(bs, length, h, hd, qc,
                                      state is not None, q.element_size()),
                        (q, k, v, logi, logf) + tuple(state or ()),
                        (out,) + fin)
        return out, fin
    dev = q.device
    handle = lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err, out, state = call(handle, q, k, v, logi, logf, state, qc,
                               stream)
    if err != 0:
        raise RuntimeError(f"mlstm: CUDA error {err} at launch")
    launches += 1
    return out, state


def call_bwd(handle, q, k, v, logi, logf, dh, qc: int, stream, binds=None):
    """``handle.ml_mlstm_bwd`` on checked, contiguous tensors of one
    device, with the gradients and the scratch allocated there (``binds``:
    a (B,H,L) f32 tensor that gets 1 where a row's floor binds, or None):
    (its return code, (dq, dk, dv, dlogi, dlogf))."""
    bs, length, h, hd = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dlogi, dlogf = torch.empty_like(logi), torch.empty_like(logf)
    floats = ctypes.c_longlong()
    handle.ml_bwd_scratch_floats(bs, length, h, hd, qc,
                                 ctypes.addressof(floats))
    scratch = torch.empty(floats.value, dtype=torch.float32,
                          device=q.device)
    err = handle.ml_mlstm_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), logi.data_ptr(),
        logf.data_ptr(), dh.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dlogi.data_ptr(), dlogf.data_ptr(),
        None if binds is None else binds.data_ptr(), scratch.data_ptr(), bs,
        length, h, hd, qc, _DTYPES[q.dtype], stream)
    return err, (dq, dk, dv, dlogi, dlogf)


def _launch_bwd(q, k, v, logi, logf, dh, chunk: int, binds=None):
    """The backward kernel on contiguous CUDA tensors in the model layout,
    from the zero state: (dq, dk, dv, dlogi, dlogf) given dh (q's shape
    and dtype)."""
    global bwd_launches
    qc = _check_cuda(q, k, v, logi, logf, None, chunk)
    if dh.shape != q.shape or dh.dtype != q.dtype or not dh.is_contiguous():
        raise ValueError(f"mlstm: dh {tuple(dh.shape)} {dh.dtype}; need "
                         "q's shape and dtype, contiguous")
    if analysis.traced(q):
        bs, length, h, hd = q.shape
        grads = tuple(torch.empty_like(t) for t in (q, k, v, logi, logf))
        torch.empty(bwd_scratch_floats(bs, length, h, hd, qc),
                    dtype=torch.float32, device=q.device)
        analysis.record("mlstm_bwd", bwd_work(bs, length, h, hd, qc,
                                              q.element_size()),
                        (q, k, v, logi, logf, dh), grads)
        return grads
    handle = bwd_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err, grads = call_bwd(handle, q, k, v, logi, logf, dh, qc, stream,
                              binds)
    if err != 0:
        raise RuntimeError(f"mlstm: CUDA error {err} at backward launch")
    bwd_launches += 1
    bwd_design_launches[bwd_design(q.dtype)] += 1
    return grads


class _MLSTM(torch.autograd.Function):
    """The forward kernel from the zero state, with the backward kernel as
    its gradient.  Nothing beyond the inputs is kept: the backward
    rebuilds the gates and the states entering the chunks.  The final
    state's gradients arrive as None (``set_materialize_grads(False)``)
    unless something read the final state; then it raises."""

    @staticmethod
    def forward(ctx, q, k, v, logi, logf, chunk):
        ctx.save_for_backward(q, k, v, logi, logf)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        out, (c, n, m) = _launch(q, k, v, logi, logf, None, chunk)
        return out, c, n, m

    @staticmethod
    def backward(ctx, dh, dc, dn, dm):
        if any(g is not None for g in (dc, dn, dm)):
            raise NotImplementedError(_STATE_GRAD)
        q, k, v, logi, logf = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(q)
        grads = _launch_bwd(q, k, v, logi, logf, dh.contiguous(), ctx.chunk)
        return (*grads, None)


def mlstm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          logi: torch.Tensor, logf: torch.Tensor, state=None, *,
          chunk: int = 128):
    """Model layout: q/k/v (B,L,H,hd); logi/logf (B,L,H); ``state`` (c
    (B,H,hd,hd), n (B,H,hd), m (B,H)) or None for the zero state.

    Returns h (B,L,H,hd) in q's dtype and the final state (c, n, m) f32:
    the kernel on CUDA tensors (with the backward kernel as its gradient
    where an input wants one, from the zero state only), the plain version
    on CPU ones."""
    _check_shapes(q, k, v, logi, logf, state)
    if analysis.on_card(q):
        if state is not None:
            state = tuple(t.float().contiguous() for t in state)
        ts = (q.contiguous(), k.contiguous(), v.contiguous(),
              logi.float().contiguous(), logf.float().contiguous())
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in ts + tuple(state or ())):
            if state is not None:
                raise NotImplementedError(_STATE_GRAD)
            out, c, n, m = _MLSTM.apply(*ts, chunk)
            return out, (c, n, m)
        return _launch(*ts, state, chunk)
    return mlstm_chunked(q, k, v, logi, logf, state, chunk)
