"""Plain PyTorch version of the mlstm kernel: the stabilised chunkwise mLSTM
(the kernel's oracle, what the wrapper computes for a tensor on the CPU,
and ``models.xlstm.mlstm_chunked``), and its gradients by autograd (the
backward kernel's oracle, ``mlstm_chunked_grads``), with the inputs the
kernels' checks share (``grad_inputs``).

The JAX package's kernel (``kernel.py:23-89``) and its model path
(``models/xlstm.py:80-160``: ``mlstm_chunk_body`` and ``mlstm_chunked``)
compute the same chunked algorithm; this is one copy of it, in the model
layout, including the ragged last chunk.  All arithmetic is in f32 and h
is rounded once to q's dtype.  The exact per-token recurrence (the JAX
package's ``ref.mlstm_ref``) stays a test oracle of the JAX package and
is not copied.  The JAX package's ``use_scan`` (a ``lax.scan`` over the
chunks in deploy mode) has no counterpart: PyTorch runs the chunk loop
eagerly either way.
"""
from __future__ import annotations

import torch

CHUNK = 1024          # models.xlstm's chunk in the JAX package
NEG = -1e30           # the stabiliser's "minus infinity"


def zero_state(bs: int, h: int, hd: int, device):
    """(c (B,H,hd,hd), n (B,H,hd), m (B,H)) f32: the state before any
    token."""
    return (torch.zeros((bs, h, hd, hd), dtype=torch.float32, device=device),
            torch.zeros((bs, h, hd), dtype=torch.float32, device=device),
            torch.full((bs, h), NEG, dtype=torch.float32, device=device))


def mlstm_chunk_body(q, k, v, logi, logf, state, binds=None):
    """One stabilised chunk.  q, k, v: (B,q,H,hd) f32; logi/logf: (B,q,H).

    state: (c (B,H,hdv,hdk), n (B,H,hdk), m (B,H)).  Returns (h, new
    state).  Exactly equivalent to the per-token recurrence.  A list
    ``binds`` gets the chunk's (B,q,H) mask of the rows whose
    denominator takes the floor exp(-m_comb)."""
    qq, hd = q.shape[1], q.shape[3]
    scale = hd ** -0.5
    c_in, n_in, m_in = state
    cumf = torch.cumsum(logf, dim=1)                          # (B,q,H)
    total = cumf[:, -1]                                       # (B,H)

    # ---- intra-chunk decay matrix (stabilised) ----
    dt = (cumf[:, :, None, :] - cumf[:, None, :, :]
          + logi[:, None, :, :])                              # (B,i,j,H)
    causal = torch.tril(torch.ones((qq, qq), dtype=torch.bool,
                                   device=q.device))
    dt = torch.where(causal[None, :, :, None], dt,
                     torch.full_like(dt, NEG))
    m_intra = dt.amax(dim=2)                                  # (B,i,H)
    b_inter = cumf + m_in[:, None, :]                         # (B,i,H)
    m_comb = torch.maximum(m_intra, b_inter)
    d = torch.exp(dt - m_comb[:, :, None, :])
    inter_scale = torch.exp(b_inter - m_comb)                 # (B,i,H)

    scores = torch.einsum("bihd,bjhd->bijh", q, k) * scale    # (B,i,j,H)
    s = scores * d
    num = torch.einsum("bijh,bjhd->bihd", s, v)
    num = num + inter_scale[..., None] * torch.einsum(
        "bhde,bihe->bihd", c_in, q) * scale
    den = s.sum(dim=2) + inter_scale * torch.einsum(
        "bhe,bihe->bih", n_in, q) * scale
    if binds is not None:
        binds.append(den.abs() < torch.exp(-m_comb))
    den = torch.maximum(den.abs(), torch.exp(-m_comb))
    ht = num / den[..., None]

    # ---- state update ----
    w = total[:, None, :] - cumf + logi                       # (B,j,H)
    m_out = torch.maximum(m_in + total, w.amax(dim=1))
    wexp = torch.exp(w - m_out[:, None, :])
    carry = torch.exp(m_in + total - m_out)
    c_out = carry[:, :, None, None] * c_in + torch.einsum(
        "bjh,bjhd,bjhe->bhde", wexp, v, k)
    n_out = carry[:, :, None] * n_in + torch.einsum(
        "bjh,bjhe->bhe", wexp, k)
    return ht, (c_out, n_out, m_out)


def mlstm_chunked(q, k, v, logi, logf, state=None, chunk: int = CHUNK,
                  binds=None):
    """Full-sequence chunkwise mLSTM.  q, k, v: (B,L,H,hd) in the model
    dtype; logi/logf: (B,L,H) f32; ``state`` as ``mlstm_chunk_body``'s, or
    None for the zero state.

    Returns h (B,L,H,hd) in q's dtype and the final state in f32.  The
    sequence runs in chunks of ``min(chunk, L)`` tokens; the last chunk
    may be shorter.  ``binds`` as ``mlstm_chunk_body``'s, a mask a
    chunk."""
    bs, length, h, hd = q.shape
    chunk = min(chunk, length)
    if chunk <= 0:
        raise ValueError(f"mlstm: chunk {chunk} for length {length}")
    if state is None:
        state = zero_state(bs, h, hd, q.device)
    state = tuple(t.float() for t in state)
    qf, kf, vf = q.float(), k.float(), v.float()
    logi, logf = logi.float(), logf.float()
    outs = []
    for i in range(0, length, chunk):
        j = min(i + chunk, length)
        ht, state = mlstm_chunk_body(qf[:, i:j], kf[:, i:j], vf[:, i:j],
                                     logi[:, i:j], logf[:, i:j], state,
                                     binds)
        outs.append(ht)
    return torch.cat(outs, dim=1).to(q.dtype), state


def mlstm_chunked_grads(q, k, v, logi, logf, chunk: int, dh):
    """The gradients (dq, dk, dv, dlogi, dlogf) of ``mlstm_chunked`` from
    the zero state, given dh (h's gradient; the final state's is 0):
    autograd of the plain version.  Each has its input's dtype."""
    leaves = [t.detach().clone().requires_grad_()
              for t in (q, k, v, logi, logf)]
    with torch.enable_grad():
        h, _ = mlstm_chunked(*leaves, None, chunk)
        return torch.autograd.grad(h, leaves, dh)


def floor_share(q, k, v, logi, logf, chunk: int) -> float:
    """The share of rows (b, t, h) whose denominator takes the floor
    exp(-m_comb) in the plain version from the zero state: there no
    gradient flows through the denominator."""
    binds = []
    with torch.no_grad():
        mlstm_chunked(q, k, v, logi, logf, None, chunk, binds)
    return torch.cat(binds, dim=1).float().mean().item()


# Planted faults of the backward kernel (csrc/mlstm_bwd.cu) that its checks
# must catch: the reverse walk drops the carry of (dC, dn) into the chunk
# before (which the slow forget gates' rows see); the floor's branch
# ignored, the gradient sent through den on every row (which the inputs
# whose floor binds on most rows see); and the bf16 route's U = dH C with
# only C's first bf16 part (the state rounded once; the common-part inputs
# see it).
BWD_CARRY_FAULT = ("        prev = cg[k] * prev + own[k];\n",
                   "        prev = REVERSE ? own[k] : cg[k] * prev + own[k];\n")
BWD_FLOOR_FAULT = (
    "    const float dden = bind ? 0.f : -sgn * ndh * rinv * rinv;\n",
    "    const float dden = -sgn * ndh * rinv * rinv;\n")
BWD_ROUND_FAULT = (
    "Gemm{seq(dh), dd(s.cst), none,",
    "Gemm{seq(dh), Op{s.cst, 0, D, 1, H * nc * dds, nc * dds, dds, 1}, none,")

# The checks' gates.  logf: "jax" draws -softplus(N(0, 1)) as the JAX kernel
# test does (about -0.8 a token: nothing outlives a 128-token chunk);
# "model" log sigmoid(N(3, 1)), the model's forget bias of 3; "slow" log
# sigmoid(N(4.6, 0.1)), about -0.01, so that C and n and their gradients
# carry over several chunks.  logi: N(-1, 1) ("random"), shifted by -6 for
# inputs whose floor binds on most rows ("floor": every den is small
# against exp(-m_comb)).  "common": v with a large common part
# MLSTM_COMMON (the state C's rows then nearly alike) and dh with its mean
# over hd taken out, so that U = dH C and dH V^T cancel that part and a
# rounding of C as an operand shows in dq.
MLSTM_GATES = {"jax": (-1.0, 0.0, 1.0), "model": (1.0, 3.0, 1.0),
               "slow": (1.0, 4.6, 0.1)}
LOGI_SHIFT = {"random": 0.0, "floor": -6.0, "common": 0.0}
MLSTM_COMMON = 16.0


def grad_inputs(bs, length, h, hd, *, gates="slow", inputs="random",
                dtype=torch.float32, seed=0, device="cpu"):
    """(q, k, v, logi, logf, dh) for a check of the mLSTM and its gradient,
    drawn from ``seed``: q, k, v, dh ~ N(0, 1), logi ~ N(-1, 1) + the
    LOGI_SHIFT of ``inputs``, logf of MLSTM_GATES[gates]; "common" inputs
    add MLSTM_COMMON to v and take dh's mean over hd out."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    q, k, v = (randn(bs, length, h, hd) for _ in range(3))
    li = randn(bs, length, h) - 1 + LOGI_SHIFT[inputs]
    sign, mean, std = MLSTM_GATES[gates]
    x = randn(bs, length, h) * std + mean
    lf = (-torch.nn.functional.softplus(x) if sign < 0
          else torch.nn.functional.logsigmoid(x))
    dh = randn(bs, length, h, hd)
    if inputs == "common":
        v, dh = v + MLSTM_COMMON, dh - dh.mean(-1, keepdim=True)
    return (q.to(dtype), k.to(dtype), v.to(dtype), li, lf, dh.to(dtype))
