"""Snapshots of job state (paper §3.1; PyTorch port of
``repro.core.snapshot``).

A snapshot holds the full training-job state (params, optimizer moments
and step) on the host, so it survives losing the device, can be diffed
(``core.diffsync``), moved (``core.migration``) and written to disk
(``checkpoint.manager``).  ``take`` copies every tensor to the CPU (bf16
stays ``torch.bfloat16``); an ``int`` leaf stays an ``int``.

``_fingerprint`` hashes what the JAX package's does, leaf by leaf in the
JAX package's order: numpy's dtype name (``"bfloat16"``, ``"float32"``),
the shape as a tuple's ``str`` (``"(16, 2048)"``, ``"()"``) and the raw
bytes, an ``int`` leaf as the JAX package's int32 step.  So a carried
state has the same fingerprint in both packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import diffsync
from repro_torch.weights import tree_leaves, tree_map, tree_unflatten


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _hash_leaf(h, head: bytes, body: np.ndarray) -> None:
    h.update(head)
    h.update(body)


def _fingerprint(leaves: Iterable[Any]) -> str:
    """sha256 over (dtype name, shape, bytes) of each leaf, first 16 hex
    digits.  Leaves may lie on any device; each is copied to the host in
    turn, so a whole state is never held twice.  A worker thread hashes
    one leaf while the next is copied (or produced by ``leaves``, which
    may be a generator): both release the interpreter lock, so a device
    state's copy to the host overlaps its hashing.  The bytes hashed, and
    their order, are those of a plain loop."""
    h = hashlib.sha256()
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = None
        for leaf in leaves:
            t = diffsync.as_tensor(leaf)
            head = (_dtype_name(t.dtype) + str(tuple(t.shape))).encode()
            t = t.cpu().contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            body = np.ascontiguousarray(t.numpy()).reshape(-1).view(np.uint8)
            if pending is not None:
                pending.result()
            pending = pool.submit(_hash_leaf, h, head, body)
        if pending is not None:
            pending.result()
    return h.hexdigest()[:16]


def fingerprint(state) -> str:
    """The snapshot fingerprint of a state tree wherever it lies (a
    restored state is checked against its snapshot's)."""
    return _fingerprint(tree_leaves(state))


def _copy_to(leaf, device: torch.device):
    """A copy of one leaf on ``device`` (never an alias: the optimizer
    updates its tensors in place).  A numpy leaf (host bookkeeping of a
    serving state) stays a numpy copy on the host."""
    if isinstance(leaf, int):
        return leaf
    if isinstance(leaf, np.ndarray):
        return np.array(leaf, copy=True)
    return leaf.detach().to(device, copy=True)


@dataclasses.dataclass
class Snapshot:
    """Point-in-time host copy of a job's state."""
    job_id: str
    step: int
    state: Any                      # host tree: CPU tensors and ints
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    fingerprint: str = ""
    wall_time: float = 0.0

    @property
    def nbytes(self) -> int:
        return diffsync.tree_nbytes(self.state)


def take(job_id: str, step: int, state, meta: Optional[Dict] = None,
         fingerprint: bool = True) -> Snapshot:
    """Snapshot device state to host memory."""
    cpu = torch.device("cpu")
    copies: list = []

    def copied():
        for leaf in tree_leaves(state):
            copies.append(_copy_to(leaf, cpu))
            yield copies[-1]
    if fingerprint:
        fp = _fingerprint(copied())     # hashes overlap the copies
    else:
        fp = ""
        for _ in copied():
            pass
    host = tree_unflatten(state, copies)
    return Snapshot(job_id=job_id, step=step, state=host,
                    meta=dict(meta or {}), fingerprint=fp,
                    wall_time=time.time())


def restore(snap: Snapshot, device="cuda"):
    """A copy of the snapshot's state on ``device`` (the JAX package
    takes shardings; the port's gang lives on one device)."""
    dev = resolve_device(device)
    return tree_map(lambda x: _copy_to(x, dev), snap.state)


def delta(parent: Snapshot, child_state, op: str = "overwrite"):
    """Chunk-diff live state against a parent snapshot (incremental
    checkpoint / delta migration payload)."""
    cpu = torch.device("cpu")
    host = tree_map(lambda x: _copy_to(x, cpu), child_state)
    return diffsync.diff_tree(parent.state, host, op=op)


def apply_delta(parent: Snapshot, diffs, step: int) -> Snapshot:
    merged = diffsync.apply_tree(parent.state, diffs)
    return Snapshot(job_id=parent.job_id, step=step, state=merged,
                    meta=dict(parent.meta),
                    fingerprint=_fingerprint(tree_leaves(merged)),
                    wall_time=time.time())


def verify(a: Snapshot, b: Snapshot) -> bool:
    """Bit-exact equality of two snapshots (migration safety check)."""
    la, lb = tree_leaves(a.state), tree_leaves(b.state)
    return len(la) == len(lb) and all(
        torch.equal(diffsync.as_tensor(x), diffsync.as_tensor(y))
        for x, y in zip(la, lb))
