"""Checkpointing built on snapshots (paper §3.4; PyTorch port of
``repro.checkpoint.manager``).

* **Full checkpoints**: the job-state snapshot written to disk, one file
  per checkpoint, and a JSON manifest with step, kind and fingerprint.
* **Incremental checkpoints** (``incremental_every``): chunk diffs against
  the last full snapshot (``core.diffsync``); restore = full + its diff.
* **Delta chains** (``delta_chain``): each save diffs against the previous
  save, rebased every ``rebase_every`` saves; restore replays the chain
  and checks the recorded fingerprint.
* **Async save**: the training loop blocks for the device-to-host copy
  (and the diff); the file is written on a background thread.  Writes
  happen one after another in save order, so the manifest lists the
  checkpoints in the order they were taken.

Files are written with ``torch.save`` (the JAX package pickles numpy
trees; the format is the port's own).  Only files this manager wrote are
loaded.  The ``stats`` of a save (``bytes``, ``full_bytes``, ``kind``,
``incremental``) are the JAX manager's for the same states.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core import diffsync, snapshot as snap_mod, telemetry
from repro_torch.weights import tree_leaves


def _own(t: torch.Tensor) -> torch.Tensor:
    """``t`` with storage of its own: ``torch.save`` writes a view's whole
    storage, and a diff's rows may be a view of a full snapshot."""
    return t if t.untyped_storage().nbytes() == t.nbytes else t.clone()


def _compact(diffs: Dict[str, diffsync.LeafDiff]) -> Dict[str, Any]:
    return {k: dataclasses.replace(d, idx=_own(d.idx), new=_own(d.new),
                                   old=_own(d.old))
            for k, d in diffs.items()}


class CheckpointManager:
    def __init__(self, directory: str, job_id: str = "job",
                 keep: int = 3, incremental_every: int = 0,
                 delta_chain: bool = False, rebase_every: int = 8):
        """``incremental_every``: if > 0, only every k-th checkpoint is
        full; the rest are diffs against the last full one.

        ``delta_chain``: write ``(base, delta*)`` chains instead: the
        first save (and every ``rebase_every``-th) is a full base, each
        save between diffs against the previous save, so per-save bytes
        track what the job dirtied since the last one.  Restore replays
        the chain in order and verifies the recorded fingerprint
        (bit-exact or it raises).  Excludes ``incremental_every``."""
        assert not (delta_chain and incremental_every), \
            "delta_chain and incremental_every are mutually exclusive"
        self.dir = directory
        self.job_id = job_id
        self.keep = keep
        self.incremental_every = incremental_every
        self.delta_chain = delta_chain
        self.rebase_every = max(1, int(rebase_every))
        os.makedirs(directory, exist_ok=True)
        self._last_full: Optional[snap_mod.Snapshot] = None
        self._chain_prev: Optional[snap_mod.Snapshot] = None
        self._chain_len = 0
        self._n_saved = 0
        self._pending: List[threading.Thread] = []
        self._failed: List[Exception] = []   # errors of async writes
        self.stats: List[Dict[str, Any]] = []

    # ---- paths --------------------------------------------------------------
    def _path(self, step: int, kind: str) -> str:
        return os.path.join(self.dir, f"{self.job_id}-{step:08d}.{kind}")

    def _manifest_path(self) -> str:
        return os.path.join(self.dir, f"{self.job_id}-manifest.json")

    def _manifest(self) -> List[Dict[str, Any]]:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except FileNotFoundError:
            return []

    def _write_manifest(self, entries) -> None:
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(entries, f, indent=1)
        os.replace(tmp, self._manifest_path())

    # ---- save ---------------------------------------------------------------
    def save(self, step: int, state, blocking: bool = True) -> Dict[str, Any]:
        """Checkpoint the state tree at ``step``."""
        t0 = time.time()
        snap = snap_mod.take(self.job_id, step, state)
        copy_s = time.time() - t0
        incremental = (self.incremental_every > 0
                       and self._last_full is not None
                       and self._n_saved % self.incremental_every != 0)
        chained = (self.delta_chain and self._chain_prev is not None
                   and self._chain_len < self.rebase_every - 1)

        base_step = None
        if chained:
            # chain link: diff against the previous save, so restore
            # replays base + every delta up to the target step
            diffs = diffsync.diff_tree(self._chain_prev.state, snap.state,
                                       op="overwrite")
            payload = {"kind": "delta", "base_step": self._chain_prev.step,
                       "diffs": diffs, "step": step,
                       "fingerprint": snap.fingerprint}
            path = self._path(step, "delta.pt")
            nbytes = diffsync.diff_nbytes(diffs)
            base_step = self._chain_prev.step
            self._chain_prev = snap
            self._chain_len += 1
        elif incremental:
            diffs = diffsync.diff_tree(self._last_full.state, snap.state,
                                       op="overwrite")
            payload = {"kind": "diff", "base_step": self._last_full.step,
                       "diffs": diffs, "step": step,
                       "fingerprint": snap.fingerprint}
            path = self._path(step, "diff.pt")
            nbytes = diffsync.diff_nbytes(diffs)
            base_step = self._last_full.step
        else:
            payload = {"kind": "full", "state": snap.state, "step": step,
                       "fingerprint": snap.fingerprint}
            path = self._path(step, "full.pt")
            nbytes = snap.nbytes
            self._last_full = snap
            self._chain_prev = snap
            self._chain_len = 0
        self._n_saved += 1
        before = self._pending[-1] if self._pending else None

        def _write():
            if before is not None:
                before.join()       # files and manifest in save order
            tmp = path + ".tmp"
            out = payload if "diffs" not in payload else \
                {**payload, "diffs": _compact(payload["diffs"])}
            torch.save(out, tmp)
            os.replace(tmp, path)
            entries = self._manifest()
            entry = {"step": step, "path": path, "kind": payload["kind"],
                     "fingerprint": snap.fingerprint, "nbytes": nbytes}
            if base_step is not None:
                entry["base_step"] = base_step
            entries.append(entry)
            self._write_manifest(entries)
            self._gc(entries)

        def _write_async():
            try:
                _write()
            except Exception as e:      # raised again by wait()
                self._failed.append(e)

        if blocking:
            self.wait()
            _write()
        else:
            t = threading.Thread(target=_write_async, daemon=True)
            t.start()
            self._pending.append(t)
        stat = {"step": step, "bytes": nbytes,
                "incremental": incremental or chained,
                "kind": payload["kind"],
                "full_bytes": snap.nbytes,
                "device_to_host_s": copy_s}
        self.stats.append(stat)
        tel = telemetry.get()
        if tel.enabled:
            tel.count(f"ckpt.save.{payload['kind']}")
            tel.count("ckpt.save.bytes", nbytes)
            tel.observe("ckpt.device_to_host_s", copy_s)
            tel.gauge("ckpt.chain_len", self._chain_len)
            p1 = time.perf_counter()
            tel.span_at("ckpt.save", p1 - (time.time() - t0), p1,
                        track=f"gang:{self.job_id}", clock="wall",
                        step=step, kind=payload["kind"], bytes=nbytes,
                        full_bytes=snap.nbytes)
        return stat

    def wait(self) -> None:
        """Wait for the pending writes; raise the first one that failed."""
        for t in self._pending:
            t.join()
        self._pending.clear()
        if self._failed:
            err, self._failed = self._failed[0], []
            raise RuntimeError("a checkpoint write failed") from err

    def _gc(self, entries) -> None:
        """Keep the last ``keep`` full checkpoints and the diffs newer than
        the oldest kept full one."""
        fulls = [e for e in entries if e["kind"] == "full"]
        if len(fulls) <= self.keep:
            return
        cutoff = fulls[-self.keep]["step"]
        kept, dropped = [], []
        for e in entries:
            (kept if e["step"] >= cutoff else dropped).append(e)
        for e in dropped:
            try:
                os.remove(e["path"])
            except FileNotFoundError:
                pass
        self._write_manifest(kept)

    # ---- restore ------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        entries = self._manifest()
        return entries[-1]["step"] if entries else None

    @staticmethod
    def _load(path: str) -> Dict[str, Any]:
        # a checkpoint holds LeafDiff records besides tensors, so the full
        # unpickler is needed; only files of this manager are loaded
        return torch.load(path, map_location="cpu", weights_only=False)

    def restore(self, step: Optional[int] = None, device="cuda"):
        """Load the state at ``step`` (default: the latest) onto ``device``
        -> (state, step).  Diff checkpoints are replayed on top of their
        base full checkpoint, delta chains link by link."""
        t0 = time.perf_counter()
        self.wait()
        entries = self._manifest()
        if not entries:
            raise FileNotFoundError("no checkpoints")
        if step is None:
            entry = entries[-1]
        else:
            entry = next(e for e in entries if e["step"] == step)
        payload = self._load(entry["path"])
        if payload["kind"] == "full":
            state = payload["state"]
        elif payload["kind"] == "delta":
            # (base, delta*) chain: walk back to the base full, replay
            # every delta in order and prove the result bit-exact against
            # the recorded fingerprint
            pos = entries.index(entry)
            chain = [payload]
            while chain[0]["kind"] != "full":
                base_step = chain[0]["base_step"]
                pos = next(i for i in range(pos - 1, -1, -1)
                           if entries[i]["step"] == base_step)
                chain.insert(0, self._load(entries[pos]["path"]))
            state = chain[0]["state"]
            for link in chain[1:]:
                state = diffsync.apply_tree(state, link["diffs"])
            fp = snap_mod._fingerprint(tree_leaves(state))
            if fp != payload["fingerprint"]:
                raise RuntimeError(
                    f"delta-chain restore at step {payload['step']} is "
                    f"not bit-exact (fingerprint mismatch)")
        else:
            base = next(e for e in entries
                        if e["kind"] == "full"
                        and e["step"] == payload["base_step"])
            state = diffsync.apply_tree(self._load(base["path"])["state"],
                                        payload["diffs"])
        snap = snap_mod.Snapshot(self.job_id, payload["step"], state,
                                 fingerprint=payload["fingerprint"])
        restored = snap_mod.restore(snap, device)
        tel = telemetry.get()
        if tel.enabled:
            t1 = time.perf_counter()
            tel.count("ckpt.restores")
            tel.observe("ckpt.restore_s", t1 - t0)
            tel.span_at("ckpt.restore", t0, t1,
                        track=f"gang:{self.job_id}", clock="wall",
                        step=payload["step"], kind=payload["kind"])
        return restored, payload["step"]
