"""Batched serving runtime: continuous prefill + decode with KV caches
(PyTorch port of ``repro.runtime.serve_loop``).

Requests carry a prompt; the runtime decodes one token per step for every
in-flight request.  The replica's **serving state** (params + decode
caches + next-token cursor + request bookkeeping) is the snapshot: taken
mid-generation, it restores into a fresh loop and generation resumes
bit-exactly.

Two engines share the Request/ServeStats types:

* ``ServeLoop``: the fixed-batch baseline: one equal-length batch,
  admitted together, drained to the slowest request before the next
  batch may start.
* ``ContinuousServeLoop``: iteration-level (continuous) batching over a
  fixed-capacity **slot array**: static-shape decode buffers, per-slot
  cursors and positions, ragged prompts prefilled in power-of-two
  buckets (exact length for recurrent configs) and spliced into a free
  slot's lane mid-generation while the other lanes keep decoding.

The loops run on the device of ``params``.  Decode updates the KV buffers
in place, so ``serve_state`` copies them and ``load_serve_state`` copies
them back: a snapshot never aliases a live loop.

Either loop runs as a gang on a shared fabric (``core.fabric``):
``attach(handle)`` places its params and in-flight state on the gang
mesh's device, and re-attaching after a migrate, rescale or resume
follows the new placement (``state`` adopts a restored or moved serving
state in the same move).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import MAMBA, MLSTM, SLSTM, ArchConfig
from repro_torch.core import telemetry
from repro_torch.models import model as model_mod
from repro_torch.models import transformer as tf
from repro_torch.models.layers import matmul_f32out
from repro_torch.weights import tree_leaves, tree_map


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    priority: int = 0               # admission class (0 = highest)
    arrival: float = 0.0            # open-loop arrival time (virtual s)
    t_admit: Optional[float] = None  # when a slot/batch accepted it
    t_first: Optional[float] = None  # first decoded token emitted
    t_done: Optional[float] = None   # last token emitted (slot freed)


@dataclasses.dataclass
class ServeStats:
    prefill_tokens: int = 0
    decoded_tokens: int = 0
    steps: int = 0
    admitted: int = 0
    finished: int = 0


def _copy(tree):
    return tree_map(lambda t: t.clone(), tree)


def _place_on_gang(loop) -> None:
    """Move a loop's params and device-side decode state onto its gang
    mesh's device (no copy when they already lie there)."""
    if loop.handle is None or loop.handle.mesh is None:
        return
    dev = loop.handle.mesh.device
    loop.device = dev
    loop.params = tree_map(lambda t: t.to(dev), loop.params)
    if loop._states is not None:
        loop._states = tree_map(lambda t: t.to(dev), loop._states)
        loop._cur = loop._cur.to(dev)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


class ServeLoop:
    """Fixed-batch serving of equal-length prompts (greedy decoding)."""

    def __init__(self, cfg: ArchConfig, params, max_len: int = 256,
                 window: int = 0):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.handle = None
        self.max_len = max_len
        self.window = window
        self._prefill = model_mod.make_prefill_step(cfg, window=window)
        self._serve = model_mod.make_serve_step(cfg, window=window)
        self.stats = ServeStats()
        # in-flight decode batch (None when idle)
        self._reqs: Optional[List[Request]] = None
        self._states = None
        self._cur = None
        self._plen = 0
        self._t = 0
        self._max_new = 0

    # ---- gang placement ----------------------------------------------------
    def attach(self, handle, state: Optional[Dict[str, Any]] = None) -> None:
        """Run this replica as a gang on a shared fabric: place params
        (and any in-flight decode state) on the gang mesh's device.
        Re-attach after a migrate/rescale/resume to follow the new
        placement; ``state`` adopts a restored/moved serving state in the
        same move."""
        self.handle = handle
        if state is not None:
            self.load_serve_state(state)
        _place_on_gang(self)

    # ---- serving state = the snapshot --------------------------------------
    def serve_state(self) -> Dict[str, Any]:
        """Tree capturing the replica mid-generation: params + decode
        caches + cursor, plus the host-side request bookkeeping, so the
        snapshot restores into a *fresh* ServeLoop, not just this one."""
        st: Dict[str, Any] = {"params": self.params}
        if self._reqs is not None:
            st["states"] = _copy(self._states)
            st["cur"] = self._cur.clone()
            st["decode"] = {
                "meta": np.asarray([self._plen, self._t, self._max_new],
                                   np.int32),
                "rids": np.asarray([r.rid for r in self._reqs], np.int32),
                "prompts": [np.asarray(r.prompt, np.int32)
                            for r in self._reqs],
                "max_new": np.asarray([r.max_new_tokens
                                       for r in self._reqs], np.int32),
                "outs": [np.asarray(r.out, np.int32) for r in self._reqs],
            }
        return st

    def load_serve_state(self, st: Dict[str, Any]) -> None:
        """Adopt a serving state; generation continues exactly where the
        snapshot was taken.  When this loop has no in-flight batch, the
        snapshot's request bookkeeping rebuilds it; an already-live batch
        keeps its own Request objects."""
        self.params = st["params"]
        if "states" in st:
            self._states = _copy(st["states"])
            self._cur = st["cur"].clone()
            dec = st.get("decode")
            if dec is not None:
                plen, t, max_new = (int(x) for x in np.asarray(dec["meta"]))
                self._plen, self._t, self._max_new = plen, t, max_new
                if self._reqs is None:
                    self._reqs = [
                        Request(rid=int(rid),
                                prompt=np.asarray(p, np.int32),
                                max_new_tokens=int(mn),
                                out=[int(x) for x in np.asarray(o)])
                        for rid, p, mn, o in zip(dec["rids"],
                                                 dec["prompts"],
                                                 dec["max_new"],
                                                 dec["outs"])]

    def _pad_states(self, states, plen: int):
        """Grow prefill KV caches to max_len-sized decode buffers.

        Which leaves are seq-sized is decided against the
        ``init_decode_state`` template shapes (built on the meta device),
        not a dimension heuristic.  With a window, an attention cache is a
        ring that decode writes position p into at slot p % size
        (``decode_attention``): a prompt longer than the ring keeps its
        last ``size`` rows, each at its own position's slot.  The prefill
        may have collected only its last rows (``make_prefill_step``)."""
        size = min(self.max_len, self.window) if self.window else self.max_len
        batch = tree_leaves(states)[0].shape[1]
        template = tf.init_decode_state(self.cfg, batch, self.max_len,
                                        self.cfg.torch_dtype(),
                                        window=self.window, device="meta")

        def pad(x, t, ring):
            if x.shape == t.shape and not ring:
                return x
            if size <= x.shape[2]:
                kept = x[:, :, -size:]
                # kept row i holds position plen - size + i
                return (torch.roll(kept, plen % size, dims=2) if ring
                        else kept.contiguous())
            out = x.new_zeros((*x.shape[:2], size, *x.shape[3:]))
            out[:, :, :x.shape[2]] = x
            return out
        return [{key: pad(s[key], t[key],
                          bool(self.window) and kind in tf._ATTN_KINDS)
                 for key in s}
                for kind, s, t in zip(self.cfg.period(), states, template)]

    # ---- decode lifecycle --------------------------------------------------
    def start(self, requests: Sequence[Request],
              extras: Optional[Dict[str, Any]] = None) -> None:
        """Admit + prefill a batch; decoding proceeds via decode_step."""
        reqs = list(requests)
        b = len(reqs)
        plen = len(reqs[0].prompt)
        if any(len(r.prompt) != plen for r in reqs):
            raise ValueError("ServeLoop takes an equal-length batch")
        tokens = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                                 dtype=torch.int32, device=self.device)
        last_logits, states = self._prefill(
            self.params, {"tokens": tokens, **(extras or {})})
        self.stats.prefill_tokens += b * plen
        self._reqs = reqs
        self._states = self._pad_states(states, plen)
        self._cur = _greedy(last_logits[:, 0])
        self._plen = plen
        self._t = 0
        self._max_new = max(r.max_new_tokens for r in reqs)

    @property
    def done(self) -> bool:
        return self._reqs is None or self._t >= self._max_new

    def decode_step(self) -> bool:
        """One token for the whole batch; returns True while decoding."""
        if self.done:
            return False
        reqs, t, b = self._reqs, self._t, len(self._reqs)
        cur = self._cur.tolist()
        live = 0
        for i, r in enumerate(reqs):
            if t < r.max_new_tokens:
                r.out.append(int(cur[i]))
                live += 1
        pos = torch.full((b, 1), self._plen + t, dtype=torch.int32,
                         device=self.device)
        logits, self._states = self._serve(self.params, self._states,
                                           self._cur[:, None], pos)
        self._cur = _greedy(logits[:, 0])
        # only requests still below their own max_new_tokens produced a
        # useful token this step
        self.stats.decoded_tokens += live
        self.stats.steps += 1
        self._t += 1
        if self.done:
            # drop the drained batch and its device buffers
            self._reqs = None
            self._states = None
            self._cur = None
            return False
        return True

    def run(self, requests: Sequence[Request],
            extras: Optional[Dict[str, Any]] = None) -> List[Request]:
        reqs = list(requests)
        self.start(reqs, extras=extras)
        while self.decode_step():
            pass
        return reqs


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------
def _bucket(n: int, lo: int = 8) -> int:
    """Next power-of-two >= n (min ``lo``): bounds the prefill shapes."""
    b = lo
    while b < n:
        b *= 2
    return b


def make_ragged_prefill(cfg: ArchConfig, window: int = 0):
    """(params, batch, length) -> (last_logits (B,1,V) f32, decode states).

    Like ``model.make_prefill_step`` but the prompt may be right-padded
    to a bucket: logits come from the *true* last position
    (``length - 1``) rather than the padded one.  Safe for attention
    states because ``decode_attention`` masks ``j <= pos`` per lane and
    every padded cache row is overwritten by a decode write before it
    first becomes attendable; recurrent blocks must be fed exact-length
    prompts (see ContinuousServeLoop)."""
    def prefill(params, batch, length: int):
        ctx = model_mod._ctx_from_batch(cfg, batch, collect_state=True,
                                        window=window, return_hidden=True)
        hidden, _, states = tf.forward(params, batch["tokens"], cfg, ctx)
        last = hidden[:, length - 1:length]
        logits = matmul_f32out(last, tf._head(params, cfg))
        return logits, states
    return prefill


class ContinuousServeLoop:
    """Iteration-level batching over a fixed-capacity slot array.

    ``slots`` lanes share one set of static-shape decode buffers
    (``tf.init_decode_state`` with batch = slots).  ``admit`` prefills
    one ragged prompt (bucketed to a power of two) and splices the
    resulting per-lane state into a free slot, mid-generation, while
    other lanes keep decoding.  ``decode_step`` advances every occupied
    lane one token with per-slot positions; a lane reaching its own
    ``max_new_tokens`` frees its slot immediately.  Inactive lanes carry
    stale values by design: every batched op is lane-independent and a
    splice rewrites the whole lane.

    The snapshot (``serve_state``) is params + buffers + cursor + the
    full slot bookkeeping; restoring into a fresh loop resumes a
    partially-occupied batch exactly.
    """

    def __init__(self, cfg: ArchConfig, params, slots: int = 4,
                 max_len: int = 256, window: int = 0):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.handle = None
        self.slots = int(slots)
        self.max_len = max_len
        self.window = window
        self.stats = ServeStats()
        self._size = min(max_len, window) if window else max_len
        # recurrent state is a running reduction over the prompt: a
        # right-padded prefill would fold pad tokens into it, so those
        # configs prefill at exact length
        self._exact_prefill = any(k in (MAMBA, MLSTM, SLSTM)
                                  for k in cfg.period())
        self._serve = model_mod.make_serve_step(cfg, window=window)
        self._prefill = make_ragged_prefill(cfg, window)
        # host-side slot bookkeeping (rides in the snapshot)
        self._reqs: List[Optional[Request]] = [None] * self.slots
        self._plen = np.zeros(self.slots, np.int32)
        self._t = np.zeros(self.slots, np.int32)
        self._max_new = np.zeros(self.slots, np.int32)
        self._done_rids: List[int] = []
        # device-side slot state (lazy until the first admit)
        self._states = None
        self._cur = None

    # ---- gang placement ----------------------------------------------------
    def attach(self, handle, state: Optional[Dict[str, Any]] = None) -> None:
        """Follow a (new) gang placement; ``state`` adopts a restored /
        moved serving state in the same move (see ServeLoop)."""
        self.handle = handle
        if state is not None:
            self.load_serve_state(state)
        _place_on_gang(self)

    # ---- slot accounting ---------------------------------------------------
    @property
    def active(self) -> int:
        return sum(1 for r in self._reqs if r is not None)

    @property
    def free_slots(self) -> int:
        return self.slots - self.active

    @property
    def done(self) -> bool:
        return self.active == 0

    def occupied_rids(self) -> List[int]:
        return [r.rid for r in self._reqs if r is not None]

    @property
    def done_rids(self) -> List[int]:
        return list(self._done_rids)

    def _occ(self) -> np.ndarray:
        return np.asarray([r is not None for r in self._reqs], bool)

    def _ensure_states(self) -> None:
        if self._states is None:
            self._states = tf.init_decode_state(
                self.cfg, self.slots, self.max_len, self.cfg.torch_dtype(),
                window=self.window, device=self.device)
            self._cur = torch.zeros((self.slots,), dtype=torch.int32,
                                    device=self.device)

    # ---- admission: ragged prefill spliced into one lane -------------------
    def _splice(self, pre, slot: int) -> None:
        for big, row in zip(tree_leaves(self._states), tree_leaves(pre)):
            row = row[:, 0]                 # drop the batch-1 axis
            lane = big[:, slot]
            if big.ndim == 5 and row.shape[1] != big.shape[2]:
                # KV-style leaf (P, B, S, kv, hd): the bucket-sized prefill
                # cache fills the front of the lane, zeros the rest
                lane[:, :row.shape[1]] = row
                lane[:, row.shape[1]:] = 0
            else:
                lane.copy_(row)

    def admit(self, req: Request, now: Optional[float] = None,
              extras: Optional[Dict[str, Any]] = None) -> Optional[int]:
        """Prefill ``req`` into a free slot; returns the slot index or
        None when the batch is full.  Runs between decode steps: the
        other lanes' in-flight state is untouched."""
        slot = next((i for i in range(self.slots)
                     if self._reqs[i] is None), None)
        if slot is None:
            return None
        prompt = np.asarray(req.prompt, np.int32)
        plen = len(prompt)
        if not 0 < plen <= self._size:
            raise ValueError(f"prompt ({plen}) must fit the decode buffer "
                             f"({self._size})")
        self._ensure_states()
        bucket = plen if self._exact_prefill \
            else min(self._size, _bucket(plen))
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :plen] = prompt
        batch = {"tokens": torch.as_tensor(tokens, device=self.device),
                 **(extras or {})}
        logits, pre = self._prefill(self.params, batch, plen)
        self._splice(pre, slot)
        self._cur[slot] = _greedy(logits[0, 0])
        self._reqs[slot] = req
        self._plen[slot] = plen
        self._t[slot] = 0
        self._max_new[slot] = req.max_new_tokens
        self.stats.prefill_tokens += plen
        self.stats.admitted += 1
        if now is not None:
            req.t_admit = now
        tel = telemetry.get()
        if tel.enabled:
            tel.count("serve.admitted")
            tel.gauge("serve.slot_occupancy", self.active / self.slots,
                      t=now)
            if now is not None:
                tel.observe("serve.queue_wait_s", now - req.arrival)
        return slot

    def _free(self, slot: int) -> None:
        req = self._reqs[slot]
        if req is not None:
            self._done_rids.append(req.rid)
        self._reqs[slot] = None
        self._plen[slot] = 0
        self._t[slot] = 0
        self._max_new[slot] = 0
        self.stats.finished += 1

    # ---- decode ------------------------------------------------------------
    def decode_step(self, now: Optional[float] = None) -> int:
        """One token for every occupied slot; returns how many lanes
        decoded."""
        act = [i for i in range(self.slots) if self._reqs[i] is not None]
        if not act:
            return 0
        tel = telemetry.get()
        t_step = time.perf_counter() if tel.enabled else 0.0
        cur = self._cur.tolist()
        for i in act:
            r = self._reqs[i]
            if not r.out and now is not None:
                r.t_first = now
                if tel.enabled:
                    tel.observe("serve.ttft_s", now - r.arrival)
            r.out.append(int(cur[i]))
        pos = np.where(self._occ(), self._plen + self._t, 0)
        pos = torch.as_tensor(pos[:, None].astype(np.int32),
                              device=self.device)
        logits, self._states = self._serve(self.params, self._states,
                                           self._cur[:, None], pos)
        self._cur = _greedy(logits[:, 0])
        for i in act:
            self._t[i] += 1
            if self._t[i] >= self._max_new[i]:
                r = self._reqs[i]
                if now is not None:
                    r.t_done = now
                    if tel.enabled and r.t_first is not None and r.out:
                        tel.observe("serve.per_token_s",
                                    (now - r.t_first)
                                    / max(1, len(r.out)))
                self._free(i)
        if tel.enabled:
            tel.count("serve.decoded_tokens", len(act))
            tel.gauge("serve.slot_occupancy", self.active / self.slots,
                      t=now)
            tel.span_at("serve.decode_step", t_step,
                        time.perf_counter(), track="serve",
                        clock="wall", lanes=len(act),
                        occupancy=self.active / self.slots)
        self.stats.decoded_tokens += len(act)
        self.stats.steps += 1
        return len(act)

    def run(self, requests: Sequence[Request]) -> List[Request]:
        """Closed-loop convenience: admit as capacity allows, decode to
        empty.  Open-loop drivers call admit/decode_step directly."""
        pending = list(requests)
        while pending or not self.done:
            while pending and self.admit(pending[0]) is not None:
                pending.pop(0)
            self.decode_step()
        return list(requests)

    # ---- serving state = the snapshot --------------------------------------
    def serve_state(self) -> Dict[str, Any]:
        st: Dict[str, Any] = {"params": self.params}
        if self._states is not None:
            st["states"] = _copy(self._states)
            st["cur"] = self._cur.clone()
            st["slots"] = {
                "occ": self._occ().astype(np.int32),
                "plen": self._plen.copy(),
                "t": self._t.copy(),
                "max_new": self._max_new.copy(),
                "rids": np.asarray([r.rid if r is not None else -1
                                    for r in self._reqs], np.int32),
                "prompts": [np.asarray(r.prompt, np.int32) if r is not None
                            else np.zeros(0, np.int32)
                            for r in self._reqs],
                "outs": [np.asarray(r.out, np.int32) if r is not None
                         else np.zeros(0, np.int32) for r in self._reqs],
                "done_rids": np.asarray(self._done_rids, np.int32),
            }
        return st

    def load_serve_state(self, st: Dict[str, Any]) -> None:
        """Adopt a snapshot: device buffers plus the slot bookkeeping,
        reconstructing Request objects for every occupied lane.  Callers
        that own the original Request objects re-link them with
        ``adopt_requests``."""
        self.params = st["params"]
        if "states" not in st:
            # params-only snapshot (taken before the first admit): a
            # rollback to it restarts from an empty slot array
            self._states = None
            self._cur = None
            self._reqs = [None] * self.slots
            self._plen[:] = 0
            self._t[:] = 0
            self._max_new[:] = 0
            self._done_rids = []
            return
        self._states = _copy(st["states"])
        self._cur = st["cur"].clone()
        sl = st["slots"]
        occ = np.asarray(sl["occ"]).astype(bool)
        self._plen = np.asarray(sl["plen"]).copy()
        self._t = np.asarray(sl["t"]).copy()
        self._max_new = np.asarray(sl["max_new"]).copy()
        self._done_rids = [int(x) for x in np.asarray(sl["done_rids"])]
        self._reqs = [
            Request(rid=int(sl["rids"][i]),
                    prompt=np.asarray(sl["prompts"][i], np.int32),
                    max_new_tokens=int(sl["max_new"][i]),
                    out=[int(x) for x in np.asarray(sl["outs"][i])])
            if occ[i] else None
            for i in range(self.slots)]

    def adopt_requests(self, requests: Sequence[Request]) -> None:
        """Re-link caller-owned Request objects (matched by rid) into
        the freshly-restored slots, truncating their ``out`` lists to
        the snapshot's decoded prefix so generation resumes exactly."""
        by_rid = {r.rid: r for r in requests}
        for i, snap_req in enumerate(self._reqs):
            if snap_req is None:
                continue
            mine = by_rid.get(snap_req.rid)
            if mine is not None:
                mine.out[:] = list(snap_req.out)
                self._reqs[i] = mine
