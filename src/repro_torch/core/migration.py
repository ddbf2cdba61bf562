"""Barrier-point migration of job state (paper §3.3; PyTorch port of
``repro.core.migration``).

At a step-boundary control point (no collective in flight) the job's
state is snapshotted and restored on the target device.
``migrate_via_snapshot`` goes through host memory and supports *delta*
migration: when the target already holds an older snapshot of the job,
only chunk diffs travel (the §4.1 diff protocol applied to moves).
``migrate_live`` is a direct device-to-device copy.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import diffsync, snapshot as snap_mod
from repro_torch.weights import tree_leaves, tree_map


def migrate_via_snapshot(job_id: str, step: int, state, dst_device="cuda",
                         prior: Optional[snap_mod.Snapshot] = None
                         ) -> Tuple[Any, Dict[str, Any]]:
    """Snapshot -> (optional delta against ``prior``) -> restore on
    ``dst_device``.  Returns (new_state, stats); ``prior`` is a snapshot
    of this job already resident at the target."""
    t0 = time.time()
    snap = snap_mod.take(job_id, step, state)
    full_bytes = snap.nbytes
    moved_bytes = full_bytes
    if prior is not None and prior.job_id == job_id:
        diffs = diffsync.diff_tree(prior.state, snap.state, op="overwrite")
        moved_bytes = diffsync.diff_nbytes(diffs)
        snap = snap_mod.apply_delta(prior, diffs, step)
    new_state = snap_mod.restore(snap, dst_device)
    return new_state, {
        "full_bytes": full_bytes,
        "moved_bytes": moved_bytes,
        "delta": prior is not None,
        "seconds": time.time() - t0,
        "fingerprint": snap.fingerprint,
    }


def migrate_live(state, dst_device):
    """Direct device-to-device copy (no host round trip).  Always a copy,
    even onto the device the state already lies on: a move between two
    virtual devices of one card must move the bytes, and the caller frees
    the old copy by dropping it.  Host-side numpy leaves (a serving
    state's slot bookkeeping) stay numpy."""
    dev = resolve_device(dst_device)

    def copy(x):
        if isinstance(x, int):
            return x
        if isinstance(x, np.ndarray):
            return np.array(x, copy=True)
        return x.detach().to(dev, copy=True)
    return tree_map(copy, state)


def verify_migration(before, after) -> bool:
    """Bit-exact check (the paper's correctness requirement for
    migration): the two states' snapshot fingerprints agree."""
    return snap_mod._fingerprint(tree_leaves(before)) == \
        snap_mod._fingerprint(tree_leaves(after))
