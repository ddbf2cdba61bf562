"""Plain PyTorch version of the moe_gmm kernel (the kernel's oracle, and
what the wrapper computes for a tensor on the CPU)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def expert_ffn_ref(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   w3: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """x: (E, M, d); w1/w3: (E, d, ff); w2: (E, ff, d) -> (E, M, d).

    The whole FFN runs in f32, h included (as the kernel keeps it), and
    rounds once to x's dtype.  ``act="gelu"`` is the tanh approximation
    (``jax.nn.gelu``'s default); with it ``w3`` is not read."""
    xf = x.float()
    h = torch.einsum("emd,edf->emf", xf, w1.float())
    if act == "silu":
        up = torch.einsum("emd,edf->emf", xf, w3.float())
        h = F.silu(h) * up
    else:
        h = F.gelu(h, approximate="tanh")
    y = torch.einsum("emf,efd->emd", h, w2.float())
    return y.to(x.dtype)


def common_part_inputs(e: int, m: int, d: int, ff: int, *,
                       dtype: torch.dtype, device="cpu", seed: int = 0):
    """x, w1, w2, w3 (SwiGLU) whose h has a large part common to each row:
    x ~ 1 + N(0, 0.25) and w1, w3 ~ (8 + N(0, 1)) / d make x w1 and x w3
    about 8 (silu nearly linear), so h is about 64 with a spread over ff
    of 0.2-2; w2's columns sum to about zero over ff, so y is the spread's
    part alone (w2 scaled to give y a unit standard deviation).  One bf16
    rounding of h then errs by up to 0.125 of h's 64, 6-60% of the spread,
    which a 2e-2 tolerance on y catches; the f32 h (or its hi + lo bf16
    pair) passes.  Made from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    x = (1 + 0.5 * randn(e, m, d)).to(dtype)
    w1, w3 = (((8 + randn(e, d, ff)) / d).to(dtype) for _ in range(2))
    w2 = randn(e, ff, d)
    w2 -= w2.mean(1, keepdim=True)
    y = expert_ffn_ref(x.float(), w1.float(), w2, w3.float())
    return x, w1, (w2 / y.std()).to(dtype), w3


def expert_ffn_grads_ref(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                         w3: torch.Tensor, dy: torch.Tensor, *,
                         act: str = "silu") -> tuple:
    """(dx, dw1, dw2, dw3): autograd of ``expert_ffn_ref`` for y's gradient
    ``dy``, each in its input's dtype (the backward kernel's oracle); with
    gelu dw3 is 0, as ``jax.grad`` gives it for an unused input."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, w1, w2, w3)]
        y = expert_ffn_ref(*leaves, act=act)
        grads = torch.autograd.grad(y, leaves, dy, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads))


def common_part_grad(e: int, m: int, d: int, *, dtype: torch.dtype,
                     device="cpu", seed: int = 0) -> torch.Tensor:
    """y's gradient dy (E, M, d) for the backward's common-part case (with
    ``common_part_inputs``): N(0, 1) with each column's mean over M taken
    out, so in dw2 = h^T dy the part of h common to every row meets a sum
    of about zero and only h's spread is left; one bf16 rounding of h
    (an error up to 0.125 of its 64) then errs by more than a 2e-2
    tolerance on dw2.  Needs M >= 2."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dy = torch.randn((e, m, d), generator=gen, device=device)
    return (dy - dy.mean(1, keepdim=True)).to(dtype)


# The backward's planted fault: moe_gmm_bwd.cu without the product of h's
# low bf16 part in dw2 = h^T dy, so h is rounded once to bf16 there.  The
# common-part cases (``common_part_inputs`` with ``common_part_grad``)
# must fail dw2, and only dw2, on such a copy.
BWD_ROUND_FAULT = (
    "          mma_step<true, true>(acc, st + B, st + 2 * B, lane, f.wr, "
    "f.wc, ks);\n", "")


def grads_close(got, ref, tol: float) -> list:
    """For each gradient of ``got`` (dx, dw1, dw2, dw3): finite and within
    ``tol`` of ``ref``'s, its atol scaled by the reference's largest
    magnitude (an f32 sum errs with the size of its terms, not of its
    result)."""
    out = []
    for g, r in zip(got, ref):
        g, r = g.float(), r.float()
        out.append(bool(torch.isfinite(g).all()) and torch.allclose(
            g, r, rtol=tol, atol=tol * r.abs().max().item()))
    return out
