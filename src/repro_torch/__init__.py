"""PyTorch/CUDA port of the ``repro`` package.

The port mirrors the JAX package module for module (``repro_torch.models``
is the counterpart of ``repro.models``, and so on) and imports neither JAX
nor anything of ``repro``.  Entry points take an explicit ``device`` that
defaults to ``"cuda"``; on a machine without a GPU they raise unless the
caller asks for the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another one.  Asking for CUDA on a machine without it raises, so no
    entry point continues on the CPU by accident."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA was requested but no GPU is available; pass "
            "device='cpu' to run on the CPU")
    return dev
