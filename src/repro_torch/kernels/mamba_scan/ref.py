"""Plain PyTorch version of the mamba_scan kernel: the Mamba2 SSD chunked
scan (the kernel's oracle, what the wrapper computes for a tensor on the
CPU, and ``models.ssm.ssd_chunked``), and its gradients by autograd (the
backward kernel's oracle, ``ssd_chunked_grads``), with the inputs the
kernels' checks share (``scan_inputs``).

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


def ssd_chunked_grads(x, dt, a, b, c, chunk: int, dy, ds_fin=None):
    """The gradients (dx, ddt, da, db, dc) of ``ssd_chunked`` at (x, dt,
    a, b, c), given dy (y's gradient, y's shape) and ``ds_fin`` (the final
    state's, (B,H,P,N) f32, or None for 0): autograd of the plain version.
    Each gradient has its input's dtype (dt and a f32)."""
    leaves = [t.detach().clone().requires_grad_() for t in (x, dt, a, b, c)]
    with torch.enable_grad():
        y, s = ssd_chunked(*leaves, chunk)
        outs, grads = [y], [dy]
        if ds_fin is not None:
            outs.append(s)
            grads.append(ds_fin)
        return torch.autograd.grad(outs, leaves, grads)


# A planted fault of the forward kernel (csrc/mamba_scan.cu): the state
# leaving a chunk is not carried into the next (``state_carry``, both
# routes), which the slow gates' checks see.
FWD_CARRY_FAULT = ("return expf(total);", "return 0.f;")


# Planted faults of the backward kernel (csrc/mamba_scan_bwd.cu) that its
# checks must catch.  BWD_CARRY_FAULT: the gradient of the state entering
# a chunk drops the carry from the one leaving it (each chunk's dS_in then
# holds only its own outputs' part), on both routes (``carry_back``), which
# the slow gates' rows see.  BWD_ROUND_FAULT: the bf16 route's dY S_in
# with only S_in's first bf16 part (the state rounded once), which the
# common-part inputs (``scan_inputs(inputs="common")``) see in dc.
BWD_CARRY_FAULT = ("  return g * ds + own;\n", "  return own;\n")
BWD_ROUND_FAULT = ("mm64<false, true, 1, NPART>(v, dYs, P2",
                   "mm64<false, true, 1, 1>(v, dYs, P2")

# The scan's gates for the checks: "jax" draws dt = softplus(N(0, 1)) and
# a = -exp(N(0, 0.3)), as the JAX kernel tests do (about 0.8 a token:
# nothing outlives a chunk); "model" the same dt with a = -(1..H), the
# model's init (a 64-token chunk decays by e^-45 or more); "slow" draws
# dt = softplus(N(-4.6, 0.1)), about 0.01 (trained Mamba2's dt range is
# [1e-3, 0.1]), with a = -exp(N(0, 0.3)), so the state and its gradient
# carry over several chunks.
SCAN_GATES = {"jax": (0.0, 1.0), "model": (0.0, 1.0), "slow": (-4.6, 0.1)}


# The checks' inputs: "random", or "common": x with a large common part
# SCAN_COMMON (each state row p then holds nearly the same values) and dy
# with its mean over P taken out, so that dY S_in and dY X^T cancel that
# part and a rounding of the state as an operand shows in dc.
SCAN_COMMON = 16.0


def scan_inputs(bs, length, h, p, n, *, gates="slow", inputs="random",
                dtype=torch.float32, seed=0, device="cpu"):
    """(x, dt, a, b, c, dy) for a check of the scan's gradient, drawn from
    ``seed``: x, b, c ~ N(0, 0.25), dy ~ N(0, 1), the gates of
    SCAN_GATES; ``inputs`` "common" adds SCAN_COMMON to x and takes dy's
    mean over P out."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    x = randn(bs, length, h, p) * 0.5
    mean, std = SCAN_GATES[gates]
    dt = torch.nn.functional.softplus(randn(bs, length, h) * std + mean)
    if gates == "model":
        a = -torch.arange(1, h + 1, dtype=torch.float32, device=device)
    else:
        a = -torch.exp(randn(h) * 0.3)
    bb, cc = randn(bs, length, n) * 0.5, randn(bs, length, n) * 0.5
    dy = randn(bs, length, h, p)
    if inputs == "common":
        x, dy = x + SCAN_COMMON, dy - dy.mean(-1, keepdim=True)
    return (x.to(dtype), dt, a, bb.to(dtype), cc.to(dtype), dy.to(dtype))


def carry_share(x, dt, a, b, c, chunk: int, s_fin) -> float:
    """How much of the final state the chunks before the last carry into
    it: max |S - S'| / max |S|, where S' is the final state from the last
    chunk alone (zero state)."""
    lo = x.shape[1] - min(chunk, x.shape[1])
    if lo == 0:
        return 0.0
    _, s1 = ssd_chunked(x[:, lo:], dt[:, lo:], a, b[:, lo:], c[:, lo:],
                        chunk)
    return ((s_fin - s1).abs().max() / s_fin.abs().max()).item()
