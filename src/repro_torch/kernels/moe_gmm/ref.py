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
