"""Plain PyTorch version of the slstm kernels: the sLSTM recurrence over a
sequence, one token at a time (the JAX package's ``lax.scan`` over
``_slstm_cell``, ``models/xlstm.py:263-290``), and its gradients by
autograd.

It is the kernels' oracle and what the wrapper computes for a tensor on
the CPU.  The loop and the cell are ``models.xlstm``'s as they were
before the kernels: the same ops in the same order, so the model's CPU
path is bit-equal to it.  ``slstm_scan`` can also return the per-step
values the backward kernel reads (``keep=True``): the gate
preactivations g (the input term plus the recurrent one) and the states
c, n, m after each step.
"""
from __future__ import annotations

import torch

NEG = -1e30           # the stabiliser's "minus infinity"
STATE_KEYS = ("c", "n", "h", "m")

# Planted faults of the forward kernel (csrc/slstm.cu), (old, new) with
# old found once: the recurrent term laid out gate-major (gate k of index
# j takes head j / hd's column k hd + j % hd) where the JAX package lays
# it out head-major; the carried state not rescaled when the stabiliser
# moves; and a consumer of the exchange that takes a ring word whatever
# its tag, so that it may read h of a step before, or the ring's zeros,
# where the step it waits for is not out yet (the checks start the
# outputs as NaN, ``ops.call(fill=...)``).
FWD_LAYOUT_FAULT = (
    "const int head = p / (4 * hd), e = p % (4 * hd);",
    "const int head = j / hd, e = k * hd + j % hd;")
FWD_RESCALE_FAULT = ("const float fi = expf(a1 - mn);",
                     "const float fi = expf(lf);")
FWD_EXCHANGE_FAULT = (
    "if ((todo >> u & 1) && (unsigned)(w[u] >> 32) == want) {",
    "if ((todo >> u & 1) && true) {")
FWD_FAULTS = {"layout": FWD_LAYOUT_FAULT, "rescale": FWD_RESCALE_FAULT,
              "exchange": FWD_EXCHANGE_FAULT}
# The backward kernel's (csrc/slstm_bwd.cu): the carry dc passed to the
# step before without its factor fi.
BWD_CARRY_FAULT = ("dcr = dc_t * fi;", "dcr = dc_t;")


def zero_state(bs: int, d: int, device=None):
    """The state before any token: c, n, h 0 and m NEG, (B,d) f32."""
    st = {k: torch.zeros((bs, d), dtype=torch.float32, device=device)
          for k in ("c", "n", "h")}
    st["m"] = torch.full((bs, d), NEG, dtype=torch.float32, device=device)
    return st


def slstm_cell(gx, state, r32, bf, n_heads: int):
    """One sLSTM step.  gx: (B,4d) input-gate preactivations, laid out
    gate-major (i, f, z, o); ``r32`` the recurrent weights (h,hd,4hd) in
    f32; ``bf`` the forget-gate bias (d,).

    The recurrent term is laid out head-major ((B,h,4*hd) flattened) and
    added to gx as it is, before the split into i, f, z, o: the JAX
    package does so (``xlstm.py:265-269``), so with d = 4*hd gate i takes
    all of head 0's recurrent output, gate f head 1's, and so on."""
    g = gate_preacts(gx, state["h"], r32, n_heads)
    gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
    logf = torch.log(torch.sigmoid(gf + bf) + 1e-9)
    m_new = torch.maximum(logf + state["m"], gi)
    fi = torch.exp(logf + state["m"] - m_new)
    ii = torch.exp(gi - m_new)
    c = fi * state["c"] + ii * torch.tanh(gz)
    n = fi * state["n"] + ii
    hy = torch.sigmoid(go) * c / torch.clamp_min(n, 1e-6)
    return {"c": c, "n": n, "h": hy, "m": m_new}


def gate_preacts(gx, h_prev, r32, n_heads: int):
    """g = gx + the recurrent term of ``h_prev`` (B,d), head-major."""
    h_heads = h_prev.reshape(gx.shape[0], n_heads, -1)
    gr = torch.einsum("bhd,hde->bhe", h_heads, r32)
    return gx + gr.reshape(gx.shape[0], -1)                 # (B,4d)


def slstm_scan(gx, r, bf, state, n_heads: int, keep: bool = False):
    """The recurrence over gx (B,L,4d) f32 from ``state`` (c, n, h, m,
    each (B,d) f32): (h (B,L,d) f32, the final state).  With ``keep`` a
    third item, the per-step values {"g": (B,L,4d), "c", "n", "m":
    (B,L,d)} f32 (g recomputed from each step's h before, as the cell
    forms it)."""
    st = state
    r32 = r.float()
    hs, keeps = [], []
    for t in range(gx.shape[1]):
        if keep:
            keeps.append(gate_preacts(gx[:, t], st["h"], r32, n_heads))
        st = slstm_cell(gx[:, t], st, r32, bf, n_heads)
        hs.append(st["h"])
        if keep:
            keeps.append(st)
    y = torch.stack(hs, dim=1)                              # (B,L,d)
    if not keep:
        return y, st
    hist = {"g": torch.stack(keeps[0::2], dim=1)}
    for key in ("c", "n", "m"):
        hist[key] = torch.stack([s[key] for s in keeps[1::2]], dim=1)
    return y, st, hist


def slstm_grads(gx, r, bf, state, n_heads: int, dy, dstate=None):
    """Autograd of ``slstm_scan`` under the loss sum(y dy) + sum over the
    final state's leaves of leaf * dstate[leaf]: the gradients of gx, r,
    bf and the initial state (a dict), all in f32 but r's (its dtype)."""
    with torch.enable_grad():
        ins = [gx.detach().float().requires_grad_(),
               r.detach().requires_grad_(),
               bf.detach().float().requires_grad_()]
        st = {k: state[k].detach().float().requires_grad_()
              for k in STATE_KEYS}
        y, fin = slstm_scan(ins[0], ins[1], ins[2], st, n_heads)
        loss = (y * dy).sum()
        for key, g in (dstate or {}).items():
            if g is not None:
                loss = loss + (fin[key] * g).sum()
        grads = torch.autograd.grad(loss, ins + [st[k] for k in STATE_KEYS],
                                    allow_unused=True)
    out = dict(zip(("gx", "r", "bf"), grads[:3]))
    out["state"] = {k: (g if g is not None else torch.zeros_like(st[k]))
                    for k, g in zip(STATE_KEYS, grads[3:])}
    return out


def slstm_inputs(b: int, length: int, d: int, n_heads: int, *, seed: int,
                 gates: str = "model", state: bool = False,
                 rdtype=torch.float32, device=None):
    """Inputs the kernels' checks share, drawn from ``seed`` on
    ``device`` (the CPU by default): gx (B,L,4d) f32 N(0, 1); r (h,hd,4hd)
    per head with a scale of its own (head k's hd^-0.5 (1 + k)), so a
    layout that mixes the heads shows; bf 3 (the model's init) or, with
    ``gates="slow"``, 7 + |N(0,1)| (sigma ~ 0.999, a carry that reaches
    thousands of steps); the zero state or, with ``state``, a drawn one
    (n > 0)."""
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    f32 = dict(generator=gen, device=device)
    hd = d // n_heads
    gx = torch.randn((b, length, 4 * d), **f32)
    r = torch.randn((n_heads, hd, 4 * hd), **f32) * hd ** -0.5
    r = r * (1 + torch.arange(n_heads, dtype=torch.float32,
                              device=device))[:, None, None]
    bf = torch.full((d,), 3.0, device=device)
    if gates == "slow":
        bf = 7.0 + torch.randn((d,), **f32).abs()
    if state:
        st = {"c": torch.randn((b, d), **f32),
              "n": torch.rand((b, d), **f32) + 0.5,
              "h": torch.randn((b, d), **f32) * 0.5,
              "m": torch.randn((b, d), **f32)}
    else:
        st = zero_state(b, d, device)
    return gx, r.to(rdtype), bf, st
