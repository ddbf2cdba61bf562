"""Wrapper of the slstm kernels: the sLSTM recurrence over a sequence in
the model's call signature.

``slstm`` takes the input gates' preactivations gx (B,L,4d) f32 (gate-major
i, f, z, o), the recurrent weights r (h,hd,4hd), the forget-gate bias bf
(d,) and the state before the sequence (c, n, h, m, each (B,d) f32), and
returns h of every step (B,L,d) f32 and the final state, as
``ref.slstm_scan`` does.  A CUDA tensor goes to the hand-written kernel
(``csrc/slstm.cu``: one cooperative launch a call, prefill or decode) or
the call raises, also where the grid cannot be co-resident on the card;
a CPU tensor goes to the plain version (``ref.slstm_scan``, the token
loop, under autograd where an input wants a gradient).  There is no
fallback from one to the other, nor to an earlier design of the kernel.
Each call hands the kernel a scratch ring (``plan``'s ``ring_words`` words
of 8 bytes) through which its blocks exchange h a step.  Where an input
wants a gradient on CUDA, the call goes through ``_SLSTM``, whose forward
also keeps each step's g and c, n, m, and whose backward is the kernel
``csrc/slstm_bwd.cu`` (dgx, dbf and the initial state's gradient, from
the final state's, which may be None) and one product for dr.
``launches`` counts forward kernel launches and ``bwd_launches``
backward ones (one each a call).  A tensor that holds no data and stands
for the card's (``kernels.analysis``) takes the kernel route up to the
launch, and is counted by ``work`` / ``bwd_work`` in place of it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import analysis
from repro_torch.kernels.slstm.ref import STATE_KEYS, slstm_scan

launches = 0            # forward kernel launches since the last reset
bwd_launches = 0        # backward kernel launches since the last reset

THREADS = 256           # a block's threads (the kernels' launch bound)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = Path(__file__).resolve().parent / "csrc" / "slstm.cu"
_BWD_SOURCE = _SOURCE.with_name("slstm_bwd.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int
# gx, r, bf, c0, n0, h0, m0, y, c, n, h, m, g_hist, c_hist, n_hist,
# m_hist, ring; B, L, H, D, rdtype, threads; stream
_SIG = {"sl_forward": [_P] * 17 + [_I] * 6 + [_P],
        "sl_plan": [_I] * 5 + [_P],
        "sl_exchange": [_I] * 7 + [_P] * 3,
        "sl_barrier": [_I] * 3 + [_P]}
# r, bf, c0, n0, m0, g_hist, c_hist, n_hist, m_hist, dy, dc_fin, dn_fin,
# dh_fin, dm_fin, dg, dbf, dc, dn, dh, dm, ring; B, L, H, D, rdtype,
# threads; stream
_BWD_SIG = {"sl_backward": [_P] * 21 + [_I] * 6 + [_P],
            "sl_bwd_plan": [_I] * 5 + [_P]}
HIST_KEYS = ("g", "c", "n", "m")
# what sl_plan / sl_bwd_plan report, in their order
PLAN_KEYS = ("jb", "blocks", "bt", "smem", "threads", "ring_words", "slots",
             "reg_slots", "tasks", "chunks_a_task", "tasks_a_group", "jbp",
             "regs", "local_bytes")
EXCHANGE_FORMS = {"tag": 0, "flag": 1}


def reset_launches() -> None:
    global launches, bwd_launches
    launches = 0
    bwd_launches = 0


def work(b: int, length: int, d: int, hd: int, rsize: int,
         keep: bool = False) -> tuple:
    """(flops, bytes) of the forward over gx (B,L,4d) f32 with r of
    ``rsize``-byte elements: per step and row the recurrent product, 2 4d
    hd FLOPs; gx read once and h (B,L,d) f32 written once, r (4d hd) and
    bf read once, the initial state's four (B,d) f32 leaves read once and
    the final state's written once; with ``keep`` also the histories g
    (B,L,4d) and c, n, m (B,L,d) f32 written once."""
    flops = 2.0 * b * length * 4 * d * hd
    nbytes = (4 * b * length * 5 * d + 4 * d * hd * rsize + 4 * d
              + 2 * 4 * 4 * b * d)
    if keep:
        nbytes += 4 * b * length * 7 * d
    return flops, nbytes


def bwd_work(b: int, length: int, d: int, hd: int, rsize: int,
             final: bool = False) -> tuple:
    """(flops, bytes) of the backward: per step and row R^T dg, 2 4d hd
    FLOPs (L products: steps 1..L-1's dh and the initial h's); r, bf, the
    initial c, n, m, the histories g (B,L,4d) and c, n, m before each
    step but the first ((B,L-1,d) each) and dy read once, with ``final``
    the final state's four gradients too; dg (B,L,4d), dbf and the initial
    state's four gradients written once."""
    flops = 2.0 * b * length * 4 * d * hd
    nbytes = (4 * d * hd * rsize + 4 * d + 3 * 4 * b * d
              + 4 * b * length * 4 * d + 3 * 4 * b * (length - 1) * d
              + 4 * b * length * d + (4 * 4 * b * d if final else 0)
              + 4 * b * length * 4 * d + 4 * d + 4 * 4 * b * d)
    return flops, nbytes


def lib():
    from repro_torch.kernels import _build
    return _build.load("slstm", _SOURCE, _SIG)


def bwd_lib():
    from repro_torch.kernels import _build
    return _build.load("slstm_bwd", _BWD_SOURCE, _BWD_SIG)


def plan(handle, b: int, d: int, h: int, dtype, bwd: bool = False,
         threads: int = THREADS) -> dict:
    """The grid a call takes (``sl_plan`` / ``sl_bwd_plan``): indices a
    block (jb, padded to jbp), blocks, rows a tile (bt), shared memory
    bytes, threads, the ring's words, R's slots a thread (``reg_slots`` of
    them at most in registers: 4 in bf16, 2 in f32; the rest in shared
    memory), the product's tasks, chunks of 128 a task and tasks a group,
    the kernel's registers a thread and local (spilled) bytes (0 where
    the library cannot tell) and, for the backward, the most heads a
    block touches (seg)."""
    out = (ctypes.c_int * 16)()
    fn = handle.sl_bwd_plan if bwd else handle.sl_plan
    err = fn(b, d, h, _DTYPES[dtype], threads, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"slstm: no plan for B {b}, d {d}, h {h} "
                           f"(error {err})")
    return dict(zip(PLAN_KEYS + (("seg",) if bwd else ()), out))


def exchange_us(handle, blocks: int, jb: int, d: int, rows: int, form: str,
                steps: int = 4096, threads: int = THREADS) -> float:
    """The forward's exchange alone (``sl_exchange``) on ``blocks`` blocks
    of ``threads``, each publishing ``jb`` of ``d`` values of ``rows`` rows
    a step and staging all of them, in form "tag" (the kernel's) or "flag"
    (one release flag a block, acquired before one read of the values):
    CUDA-event microseconds a step over ``steps`` steps (on the card)."""
    ring = torch.empty(2 * rows * d, dtype=torch.int64, device="cuda")
    flags = torch.empty(blocks, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    err = handle.sl_exchange(blocks, threads, d, jb, rows, steps,
                             EXCHANGE_FORMS[form], ring.data_ptr(),
                             flags.data_ptr(), stream)
    ev[1].record()
    torch.cuda.synchronize()
    if err != 0:
        raise RuntimeError(f"slstm: CUDA error {err} at sl_exchange")
    return ev[0].elapsed_time(ev[1]) / steps * 1e3


def _check_shapes(gx, r, bf, state):
    if gx.dim() != 3 or r.dim() != 3:
        raise ValueError(f"slstm: gx must be (B,L,4d) and r (h,hd,4hd), "
                         f"got {tuple(gx.shape)} and {tuple(r.shape)}")
    bs, length, d4 = gx.shape
    h, hd, hd4 = r.shape
    d = h * hd
    if (length < 1 or hd4 != 4 * hd or d4 != 4 * d
            or tuple(bf.shape) != (d,)):
        raise ValueError(f"slstm: shapes gx {tuple(gx.shape)} r "
                         f"{tuple(r.shape)} bf {tuple(bf.shape)}; need gx "
                         f"(B,L>=1,4d), r (h,hd,4hd) with h hd = d, bf (d,)")
    got = {k: tuple(state[k].shape) for k in STATE_KEYS}
    if any(s != (bs, d) for s in got.values()):
        raise ValueError(f"slstm: state shapes {got}, want {(bs, d)} each")


def _check_cuda(gx, r, bf, state):
    """Raise unless the inputs are contiguous CUDA tensors of one device
    and of the kernel's dtypes."""
    _check_shapes(gx, r, bf, state)
    ts = (gx, r, bf) + tuple(state[k] for k in STATE_KEYS)
    if not all(analysis.on_card(t) and t.device == gx.device for t in ts):
        raise TypeError("slstm: gx, r, bf and the state must be on one "
                        "CUDA device")
    if r.dtype not in _DTYPES or any(t.dtype != torch.float32
                                     for t in ts if t is not r):
        raise TypeError(f"slstm: dtypes {[t.dtype for t in ts]}; need r "
                        "float32 or bfloat16, the rest float32")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("slstm: inputs must be contiguous")


def _outputs(gx, keep: bool, fill=None):
    """y, the final state and, with ``keep``, the histories of a call;
    each starts as ``fill`` where one is given."""
    bs, length, d4 = gx.shape
    d = d4 // 4
    f32 = dict(dtype=torch.float32, device=gx.device)
    new = (lambda shape: torch.empty(shape, **f32)) if fill is None \
        else (lambda shape: torch.full(shape, fill, **f32))
    y = new((bs, length, d))
    fin = {k: new((bs, d)) for k in STATE_KEYS}
    hist = None
    if keep:
        hist = {"g": new((bs, length, d4))}
        hist.update({k: new((bs, length, d)) for k in ("c", "n", "m")})
    return y, fin, hist


def call(handle, gx, r, bf, state, keep: bool, stream,
         threads: int = THREADS, fill=None):
    """``handle.sl_forward`` on checked, contiguous tensors of one device,
    with the outputs allocated there (starting as ``fill``, a check's
    poison, where one is given): (its return code, y, the final state,
    the histories or None)."""
    y, fin, hist = _outputs(gx, keep, fill)
    bs, length, d4 = gx.shape
    h = r.shape[0]
    ring = torch.empty(plan(handle, bs, d4 // 4, h, r.dtype,
                            threads=threads)["ring_words"],
                       dtype=torch.int64, device=gx.device)
    hp = [None] * 4 if hist is None else [hist[k].data_ptr()
                                          for k in HIST_KEYS]
    err = handle.sl_forward(
        gx.data_ptr(), r.data_ptr(), bf.data_ptr(),
        *(state[k].data_ptr() for k in STATE_KEYS), y.data_ptr(),
        *(fin[k].data_ptr() for k in STATE_KEYS), *hp, ring.data_ptr(), bs,
        length, h, d4 // 4, _DTYPES[r.dtype], threads, stream)
    return err, y, fin, hist


def _launch(gx, r, bf, state, keep: bool):
    """The forward kernel on contiguous CUDA tensors."""
    global launches
    _check_cuda(gx, r, bf, state)
    bs, length, d4 = gx.shape
    if analysis.traced(gx):
        y, fin, hist = _outputs(gx, keep)
        analysis.record("slstm", work(bs, length, d4 // 4, r.shape[1],
                                      r.element_size(), keep),
                        (gx, r, bf) + tuple(state[k] for k in STATE_KEYS),
                        (y,) + tuple(fin.values())
                        + tuple((hist or {}).values()))
        return y, fin, hist
    dev = gx.device
    handle = lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err, y, fin, hist = call(handle, gx, r, bf, state, keep, stream)
    if err != 0:
        raise RuntimeError(f"slstm: CUDA error {err} at launch (82: the "
                           "grid cannot be co-resident)")
    launches += 1
    return y, fin, hist


def _bwd_outputs(r, hist, fill=None):
    """dg, dbf and the initial state's gradients of a backward call; each
    starts as ``fill`` where one is given."""
    bs, length, d4 = hist["g"].shape
    f32 = dict(dtype=torch.float32, device=r.device)
    new = (lambda shape: torch.empty(shape, **f32)) if fill is None \
        else (lambda shape: torch.full(shape, fill, **f32))
    dg = new((bs, length, d4))
    dbf = new((d4 // 4,))
    dstate = {k: new((bs, d4 // 4)) for k in STATE_KEYS}
    return dg, dbf, dstate


def call_bwd(handle, r, bf, state, hist, dy, dfin, stream,
             threads: int = THREADS, fill=None):
    """``handle.sl_backward`` on checked, contiguous tensors of one device
    (``dfin``: the final state's gradients, a dict whose values may be
    None), with the outputs allocated there (starting as ``fill``, a
    check's poison, where one is given): (its return code, dg, dbf, the
    initial state's gradients)."""
    dg, dbf, dstate = _bwd_outputs(r, hist, fill)
    bs, length, d4 = dg.shape
    ring = torch.empty(plan(handle, bs, d4 // 4, r.shape[0], r.dtype,
                            bwd=True, threads=threads)["ring_words"],
                       dtype=torch.int64, device=r.device)
    fin = [None if dfin.get(k) is None else dfin[k].data_ptr()
           for k in ("c", "n", "h", "m")]
    err = handle.sl_backward(
        r.data_ptr(), bf.data_ptr(),
        *(state[k].data_ptr() for k in ("c", "n", "m")),
        *(hist[k].data_ptr() for k in HIST_KEYS), dy.data_ptr(), *fin,
        dg.data_ptr(), dbf.data_ptr(),
        *(dstate[k].data_ptr() for k in ("c", "n", "h", "m")),
        ring.data_ptr(), bs, length, r.shape[0], d4 // 4, _DTYPES[r.dtype],
        threads, stream)
    return err, dg, dbf, dstate


def _launch_bwd(r, bf, state, hist, dy, dfin):
    """The backward kernel: (dg, dbf, the initial state's gradients)."""
    global bwd_launches
    if analysis.traced(r):
        dg, dbf, dstate = _bwd_outputs(r, hist)
        bs, length, d4 = dg.shape
        final = any(v is not None for v in dfin.values())
        analysis.record("slstm_bwd", bwd_work(bs, length, d4 // 4,
                                              r.shape[1], r.element_size(),
                                              final),
                        (r, bf, dy) + tuple(hist.values()),
                        (dg, dbf) + tuple(dstate.values()))
        return dg, dbf, dstate
    handle = bwd_lib()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err, dg, dbf, dstate = call_bwd(handle, r, bf, state, hist, dy,
                                        dfin, stream)
    if err != 0:
        raise RuntimeError(f"slstm: CUDA error {err} at backward launch")
    bwd_launches += 1
    return dg, dbf, dstate


def recurrent_grad(h_before, dg, h: int):
    """dr = sum over (b, t) of h_{t-1}^T dg_t per head, (h,hd,4hd) f32:
    ``h_before`` (B,L,d) is h of the step before each step."""
    bs, length, d = h_before.shape
    return torch.einsum("nhi,nhe->hie", h_before.reshape(bs * length, h, -1),
                        dg.reshape(bs * length, h, -1))


class _SLSTM(torch.autograd.Function):
    """The forward kernel, keeping each step's g and c, n, m, with the
    backward kernel as its gradient; dr is one product after it.  The
    final state's gradients arrive as None unless something read it
    (``set_materialize_grads(False)``)."""

    @staticmethod
    def forward(ctx, gx, r, bf, c0, n0, h0, m0):
        state = dict(zip(STATE_KEYS, (c0, n0, h0, m0)))
        y, fin, hist = _launch(gx, r, bf, state, keep=True)
        ctx.save_for_backward(r, bf, c0, n0, h0, m0, y,
                              *(hist[k] for k in HIST_KEYS))
        ctx.set_materialize_grads(False)
        return (y,) + tuple(fin[k] for k in STATE_KEYS)

    @staticmethod
    def backward(ctx, dy, dc, dn, dh, dm):
        r, bf, c0, n0, h0, m0, y, *hs = ctx.saved_tensors
        state = {"c": c0, "n": n0, "m": m0}
        hist = dict(zip(HIST_KEYS, hs))
        dy = torch.zeros_like(y) if dy is None else dy.contiguous()
        dfin = {k: (None if g is None else g.float().contiguous())
                for k, g in zip(STATE_KEYS, (dc, dn, dh, dm))}
        dg, dbf, dst = _launch_bwd(r, bf, state, hist, dy, dfin)
        h_before = torch.cat([h0[:, None], y[:, :-1]], dim=1)
        dr = recurrent_grad(h_before, dg, r.shape[0]).to(r.dtype)
        return (dg, dr, dbf) + tuple(dst[k] for k in STATE_KEYS)


def slstm(gx: torch.Tensor, r: torch.Tensor, bf: torch.Tensor, state):
    """gx (B,L,4d) f32, r (h,hd,4hd), bf (d,), ``state`` a dict of c, n,
    h, m (B,d) f32.  Returns h of every step (B,L,d) f32 and the final
    state (a dict): the kernel on CUDA tensors (with the backward kernel
    as its gradient where an input wants one), the plain version on CPU
    ones."""
    _check_shapes(gx, r, bf, state)
    if analysis.on_card(gx):
        gx = gx.float().contiguous()
        bf = bf.float().contiguous()
        r = r.contiguous()
        st = {k: state[k].float().contiguous() for k in STATE_KEYS}
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (gx, r, bf, *st.values())):
            y, *fin = _SLSTM.apply(gx, r, bf, *(st[k] for k in STATE_KEYS))
            return y, dict(zip(STATE_KEYS, fin))
        y, fin, _ = _launch(gx, r, bf, st, keep=False)
        return y, fin
    return slstm_scan(gx, r, bf, state, r.shape[0])
