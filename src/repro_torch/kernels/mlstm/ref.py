"""Plain PyTorch version of the mlstm kernel: the stabilised chunkwise mLSTM
(the kernel's oracle, what the wrapper computes for a tensor on the CPU,
and ``models.xlstm.mlstm_chunked``).

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


def mlstm_chunk_body(q, k, v, logi, logf, state):
    """One stabilised chunk.  q, k, v: (B,q,H,hd) f32; logi/logf: (B,q,H).

    state: (c (B,H,hdv,hdk), n (B,H,hdk), m (B,H)).  Returns (h, new
    state).  Exactly equivalent to the per-token recurrence."""
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


def mlstm_chunked(q, k, v, logi, logf, state=None, chunk: int = CHUNK):
    """Full-sequence chunkwise mLSTM.  q, k, v: (B,L,H,hd) in the model
    dtype; logi/logf: (B,L,H) f32; ``state`` as ``mlstm_chunk_body``'s, or
    None for the zero state.

    Returns h (B,L,H,hd) in q's dtype and the final state in f32.  The
    sequence runs in chunks of ``min(chunk, L)`` tokens; the last chunk
    may be shorter."""
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
                                     logi[:, i:j], logf[:, i:j], state)
        outs.append(ht)
    return torch.cat(outs, dim=1).to(q.dtype), state
