"""The kernel wrappers' analysis route: a kernel counted, not launched.

A tensor that holds no data can stand for one on the card: a
``FakeTensor`` on CUDA always does, and inside a card trace
(``launch.hloanalysis.Recorder``) a meta or fake tensor on any device
does.  Given such a tensor a wrapper takes the kernel's own route as far
as the launch, allocating the same outputs and scratch with
``torch.empty``, and in place of the launch records the kernel with its
``work()`` here.  It touches no stream and no library, and adds nothing
to the wrapper's launch counts.  A meta tensor outside a card trace keeps
the plain route, as a CPU tensor does, and a real CUDA tensor launches
the kernel.

Card traces run on the meta device because a CPU-only PyTorch aborts in
autograd on a fake CUDA tensor (it has no CUDA device guard), so the
backward of a training step could not be traced there.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor

_RECORDERS: list = []     # the active card traces, innermost last


def traced(t: torch.Tensor) -> bool:
    """Does ``t`` hold no data and stand for a tensor on the card?"""
    if isinstance(t, FakeTensor):
        return t.is_cuda or bool(_RECORDERS)
    return t.is_meta and bool(_RECORDERS)


def on_card(t: torch.Tensor) -> bool:
    """Does ``t`` take the card's route: a CUDA tensor, or one traced as
    the card's?"""
    return t.is_cuda or traced(t)


def record(kernel: str, work: tuple, inputs: Sequence[torch.Tensor],
           outputs: Sequence[torch.Tensor], launches: int = 1) -> None:
    """Count one call of ``kernel`` (``launches`` CUDA launches) of
    ``work`` = (flops, bytes), reading ``inputs`` and writing ``outputs``,
    with the innermost card trace, if any."""
    if _RECORDERS:
        _RECORDERS[-1].kernel(kernel, work, inputs, outputs, launches)


def pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs an attention over ``s`` tokens scores: key
    j <= i when causal, and i - j < window when a window is set."""
    hi = s * (s + 1) // 2 if causal else s * s
    lo = (s - window) * (s - window + 1) // 2 if window and s > window else 0
    return hi - lo
