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
