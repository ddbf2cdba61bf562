"""Deterministic, checkpointable synthetic token pipeline (PyTorch port of
``repro.data.pipeline``).

Every batch is a pure function of ``(seed, step)``: a ``torch.Generator``
is seeded from both, and there is no iterator state beyond the step
counter, so any Granule can regenerate the batch slice it owes for step
``s``.  The distribution is the JAX package's: a Zipf-like unigram mix
with short-range repetition (token t copies token t-k with probability
``repeat_p``), so cross-entropy falls during training.  The batches do
not match the JAX package's bit for bit: JAX draws with threefry, PyTorch
with its own generator.  The parity tests feed the JAX batches in.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab: int = 32000
    seq_len: int = 128
    global_batch: int = 8
    zipf_a: float = 1.2
    repeat_p: float = 0.3          # P[token t copies token t-k]
    repeat_k: int = 8


def _generator(seed: int, step: int) -> torch.Generator:
    # one 63-bit seed per (seed, step) pair (a splitmix64-style mix)
    z = (seed * 0x9E3779B97F4A7C15 + step + 1) & (2 ** 64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
    return torch.Generator().manual_seed((z ^ (z >> 31)) >> 1)


def make_batch(cfg: DataConfig, step: int,
               extras: Optional[Dict[str, Tuple[Sequence[int],
                                                torch.dtype]]] = None
               ) -> Dict[str, Any]:
    """Global batch for ``step`` on the CPU; identical for any layout.
    ``extras`` maps a name to (shape, dtype) of a standard-normal input
    (the audio and vision families' frames and image tokens)."""
    gen = _generator(cfg.seed, step)
    b, s = cfg.global_batch, cfg.seq_len
    ranks = torch.arange(1, cfg.vocab + 1, dtype=torch.float64)
    probs = torch.softmax(-cfg.zipf_a * torch.log(ranks), dim=0)
    base = torch.multinomial(probs, b * (s + 1), replacement=True,
                             generator=gen).reshape(b, s + 1)
    rep = torch.rand((b, s + 1), generator=gen) < cfg.repeat_p
    shifted = torch.roll(base, cfg.repeat_k, dims=1)
    toks = torch.where(rep, shifted, base).to(torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for name, (shape, dtype) in (extras or {}).items():
        batch[name] = torch.randn(tuple(shape), generator=gen).to(dtype)
    return batch


def shard_slice(batch, rank: int, world: int):
    """The per-Granule slice of a global batch (rank-addressed, stable
    across migration: slices depend only on (rank, world))."""
    def one(x):
        per = x.shape[0] // world
        return x[rank * per:(rank + 1) * per]
    return {k: one(v) for k, v in batch.items()}


@dataclasses.dataclass
class Cursor:
    """The *only* pipeline state: it goes into every snapshot."""
    step: int = 0

    def advance(self) -> "Cursor":
        return Cursor(self.step + 1)
