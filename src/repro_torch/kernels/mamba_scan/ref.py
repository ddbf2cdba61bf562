"""Plain PyTorch version of the mamba_scan kernel: the Mamba2 SSD chunked
scan (the kernel's oracle, what the wrapper computes for a tensor on the
CPU, and ``models.ssm.ssd_chunked``).

The JAX package's kernel (``kernel.py:28-74``) and its model path
(``models/ssm.py:70-121``) compute the same chunked algorithm; this is one
copy of it, in the model layout.  The exact sequential recurrence
(the JAX package's ``ref.ssd_ref``) stays a test oracle of the JAX
package and is not copied.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def chunk_len(length: int, chunk: int) -> int:
    """The chunk the scan uses for ``length`` tokens: ``min(chunk,
    length)``, which must divide ``length`` (a ragged tail cannot be
    scanned, as in the JAX package's kernel and model path)."""
    q = min(chunk, length)
    if q <= 0 or length % q:
        raise ValueError(f"mamba_scan: sequence length {length} is not a "
                         f"multiple of the chunk {q}")
    return q


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int):
    """x: (B,L,H,P) in the model dtype; dt: (B,L,H) f32; a: (H,) f32,
    negative; b, c: (B,L,N).

    Returns y (B,L,H,P) in x's dtype and the final state (B,H,P,N) f32.
    Everything runs in f32."""
    bs, length, h, p = x.shape
    n = b.shape[-1]
    q = chunk_len(length, chunk)
    nc = length // q
    xc = x.reshape(bs, nc, q, h, p).float()
    dtc = dt.reshape(bs, nc, q, h).float()
    bc = b.reshape(bs, nc, q, n).float()
    cc = c.reshape(bs, nc, q, n).float()

    da = dtc * a.float()                                   # (B,nc,q,H)
    cum = torch.cumsum(da, dim=2)                          # inclusive
    total = cum[:, :, -1]                                  # (B,nc,H)

    # within the chunk: decay(i, j) = exp(cum_i - cum_j) for i >= j, the
    # causal mask applied before exp
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,i,j,H)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))
    seg = torch.where(causal[None, None, :, :, None], seg,
                      torch.full_like(seg, NEG_INF))
    decay = torch.exp(seg)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)
    m = scores[..., None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xc)

    # chunk states: S_c = sum_j exp(total - cum_j) dt_j B_j (x) x_j
    w = torch.exp(total[:, :, None, :] - cum) * dtc         # (B,nc,q,H)
    states = torch.einsum("bcjh,bcjn,bcjhp->bchpn", w, bc, xc)

    # inter-chunk recurrence over the chunks
    gamma = torch.exp(total)                                # (B,nc,H)
    s = torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
    s_in = []
    for ci in range(nc):
        s_in.append(s)
        s = s * gamma[:, ci, :, None, None] + states[:, ci]
    s_in = torch.stack(s_in, dim=1)                         # (B,nc,H,P,N)

    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", cc, s_in,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(bs, length, h, p)
    return y.to(x.dtype), s
