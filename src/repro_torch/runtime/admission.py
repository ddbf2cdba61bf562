"""Admission control for open-loop serving: arrival streams, a priority
queue, latency tracking, and the open-loop drivers (PyTorch port of
``repro.runtime.admission``).

Requests arrive on their own clock (``core.arrivals.arrival_times``:
Poisson / diurnal / burst), wait in an ``AdmissionQueue`` ordered by
(priority class, arrival), and enter a ``ContinuousServeLoop`` slot as
soon as one frees.  Two drivers replay the same stream against real
engines on a deterministic virtual clock (one decode step = ``step_s``):

* ``run_open_loop``: the continuous engine: admit-on-free-slot,
  per-request completion times.
* ``run_fixed_batch``: the fixed-batch baseline: wait for a full batch,
  drain it to the slowest member, repeat.

``ServeAutoscaler`` is the control loop: it watches queue depth and the
sliding-window p99 per-token latency against a ``ServeSLO`` and asks
``ElasticPolicy.decide_scaled`` / ``PlacementEngine`` for grow, shrink
or clone actions, the same placement path trace jobs use, so serve
capacity and training tenants contend under one accounting.  Its
``ServeSLO``, ``ScaleAction`` and ``ServeAutoscaler`` are the JAX
module's, line for line.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import telemetry
from repro_torch.core.arrivals import ARRIVAL_REGIMES, arrival_times
from repro_torch.runtime.serve_loop import Request

__all__ = ["ARRIVAL_REGIMES", "AdmissionQueue", "LatencyWindow",
           "ScaleAction", "ServeAutoscaler", "ServeReport", "ServeSLO",
           "request_stream", "run_fixed_batch", "run_open_loop"]


def request_stream(n: int, rate: float, seed: int,
                   regime: str = "poisson", vocab: int = 256,
                   prompt_lens: Tuple[int, int] = (4, 12),
                   max_new: Tuple[int, int] = (4, 12),
                   priority_classes: Optional[Sequence[Tuple[int, float]]]
                   = None) -> List[Request]:
    """``n`` serve requests with open-loop arrivals at offered load
    ``rate`` (req/s of virtual time).  Prompt lengths and decode budgets
    draw uniformly from their ranges (ragged by default); priorities
    sample from ``priority_classes`` [(class, weight)].  Deterministic
    given ``seed`` — the arrival process and the payload draws use
    separate rng streams, so changing the regime keeps the payloads."""
    times = arrival_times(n, rate, seed, regime=regime)
    rng = np.random.default_rng([seed, 3])
    lo_p, hi_p = prompt_lens
    lo_m, hi_m = max_new
    pris = np.zeros(n, np.int64)
    if priority_classes:
        classes = [p for p, _ in priority_classes]
        w = np.asarray([w for _, w in priority_classes], np.float64)
        picks = np.random.default_rng([seed, 4]).choice(
            len(classes), size=n, p=w / w.sum())
        pris = np.asarray([classes[int(k)] for k in picks], np.int64)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab, int(rng.integers(
                        lo_p, hi_p + 1)), dtype=np.int32),
                    max_new_tokens=int(rng.integers(lo_m, hi_m + 1)),
                    priority=int(pris[i]),
                    arrival=float(times[i]))
            for i in range(n)]


class AdmissionQueue:
    """Priority admission queue: requests pop by (priority class,
    arrival, rid) — class 0 first, FIFO within a class.  The same
    priority ordering the trace scheduler applies to jobs, so a serve
    request and a training job at the same class rank consistently."""

    def __init__(self) -> None:
        self._heap: List[Tuple[int, float, int, Request]] = []

    def push(self, req: Request) -> None:
        heapq.heappush(self._heap,
                       (req.priority, req.arrival, req.rid, req))
        tel = telemetry.get()
        if tel.enabled:
            tel.count("serve.queued")
            tel.gauge("serve.queue_depth", len(self._heap),
                      t=req.arrival)

    def pop(self) -> Request:
        req = heapq.heappop(self._heap)[3]
        tel = telemetry.get()
        if tel.enabled:
            tel.gauge("serve.queue_depth", len(self._heap))
        return req

    def peek(self) -> Optional[Request]:
        return self._heap[0][3] if self._heap else None

    def depth(self) -> int:
        return len(self._heap)

    def __len__(self) -> int:
        return len(self._heap)


class LatencyWindow:
    """Sliding window of completed-request latency samples; the
    autoscaler's measurement side.  Per-token latency of a finished
    request = (t_done - arrival) / tokens — queueing delay included,
    which is exactly what an end user experiences."""

    def __init__(self, window: int = 64) -> None:
        self.window = int(window)
        self._samples: List[float] = []

    def record(self, req: Request) -> None:
        if req.t_done is None or not req.out:
            return
        lat = (req.t_done - req.arrival) / len(req.out)
        self._samples.append(lat)
        tel = telemetry.get()
        if tel.enabled:
            tel.observe("serve.latency_per_token_s", lat)
        if len(self._samples) > self.window:
            del self._samples[:-self.window]

    def percentile(self, q: float) -> Optional[float]:
        if not self._samples:
            return None
        return float(np.percentile(np.asarray(self._samples), q))

    @property
    def p50(self) -> Optional[float]:
        return self.percentile(50.0)

    @property
    def p99(self) -> Optional[float]:
        return self.percentile(99.0)


@dataclasses.dataclass
class ServeSLO:
    """The serve objective the autoscaler holds: p99 per-token latency
    below ``target_p99_s`` with queue depth bounded per slot."""
    target_p99_s: float = 0.5
    queue_high: float = 2.0        # queued requests per slot -> grow
    queue_low: float = 0.25        # queued requests per slot -> shrink
    headroom: float = 0.6          # shrink only when p99 < headroom*target


@dataclasses.dataclass
class ScaleAction:
    gang_id: str
    kind: str            # "grow" | "shrink" | "clone" | "need"
    world: int           # target world (new gang world for clone)


class ServeAutoscaler:
    """SLO-driven control loop over one or more serve gangs.

    Each control tick compares the measured p99 per-token latency and
    queue pressure against the ``ServeSLO`` and emits ``ScaleAction``s:

    * breach (p99 over target, or queue above ``queue_high``/slot) →
      grow the busiest gang 2x through ``ElasticPolicy.decide_scaled``;
      if the policy can't grow it (budget/probe), **clone** a new gang
      at base world instead — scale out when scale up is exhausted.
    * comfortable (p99 under ``headroom``*target and queue below
      ``queue_low``/slot) → shrink the largest gang 2x, retiring clones
      at min world, returning chips to the pool for training backfill.

    A cooldown of ``cooldown_s`` separates actions so one decision's
    effect lands in the window before the next is taken.  The caller
    applies actions (rescale / spawn / retire) — the controller only
    decides, against the same engine accounting placements use.
    """

    def __init__(self, policy, engine, slo: Optional[ServeSLO] = None,
                 slots_per_chip: int = 1, base_world: Optional[int] = None,
                 cooldown_s: float = 2.0, kind: str = "omp"):
        self.policy = policy
        self.engine = engine
        self.slo = slo or ServeSLO()
        self.slots_per_chip = int(slots_per_chip)
        self.base_world = base_world or policy.min_world
        self.cooldown_s = float(cooldown_s)
        self.kind = kind
        self._last_action_t = -1e18
        self.actions: List[Tuple[float, ScaleAction]] = []

    def _emit(self, now: float, act: ScaleAction) -> List[ScaleAction]:
        self._last_action_t = now
        self.actions.append((now, act))
        return [act]

    def decide(self, now: float, queue_depth: int,
               p99: Optional[float],
               gang_worlds: Dict[str, int]) -> List[ScaleAction]:
        if not gang_worlds or now - self._last_action_t < self.cooldown_s:
            return []
        slots = sum(gang_worlds.values()) * self.slots_per_chip
        per_slot = queue_depth / max(1, slots)
        breach = (p99 is not None and p99 > self.slo.target_p99_s) \
            or per_slot > self.slo.queue_high
        comfy = (p99 is None or p99 < self.slo.headroom
                 * self.slo.target_p99_s) \
            and per_slot < self.slo.queue_low
        if breach:
            # grow the most loaded gang; clone when grow is impossible;
            # when the pool itself is exhausted, emit "need" — the
            # fleet's cue to reclaim chips from elastic tenants (a
            # training gang drains at its control point) and retry
            gid = max(gang_worlds, key=lambda g: (-gang_worlds[g], g))
            new = self.policy.decide_scaled(gang_worlds[gid], self.engine,
                                            2.0, kind=self.kind)
            if new is not None and new > gang_worlds[gid]:
                return self._emit(now, ScaleAction(gid, "grow", new))
            res = self.engine.reserve(self.base_world, kind=self.kind)
            if res is not None:
                self.engine.cancel(res)
                return self._emit(
                    now, ScaleAction(f"clone-{len(self.actions)}",
                                     "clone", self.base_world))
            want = min(self.policy.max_world, gang_worlds[gid] * 2)
            if want > gang_worlds[gid]:
                return self._emit(now, ScaleAction(gid, "need", want))
            return []
        if comfy and (len(gang_worlds) > 1
                      or max(gang_worlds.values()) > self.policy.min_world):
            gid = max(gang_worlds, key=lambda g: (gang_worlds[g], g))
            new = self.policy.decide_scaled(gang_worlds[gid], self.engine,
                                            0.5, kind=self.kind)
            if new is not None and new < gang_worlds[gid]:
                return self._emit(now, ScaleAction(gid, "shrink", new))
            if len(gang_worlds) > 1:    # clone already at min world
                return self._emit(now, ScaleAction(gid, "shrink", 0))
        return []


# ---------------------------------------------------------------------------
# Open-loop drivers for real engines (virtual step clock)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ServeReport:
    finished: int
    elapsed_s: float
    decoded_tokens: int
    prefill_tokens: int
    steps: int
    tokens_per_s: float
    token_lat_p50: float
    token_lat_p99: float
    ttft_p50: float
    ttft_p99: float
    queue_wait_p50: float
    queue_wait_p99: float

    @staticmethod
    def from_requests(reqs: Sequence[Request], stats,
                      elapsed: float) -> "ServeReport":
        done = [r for r in reqs if r.t_done is not None and r.out]
        tok = np.asarray([(r.t_done - r.arrival) / len(r.out)
                          for r in done]) if done else np.asarray([0.0])
        ttft = np.asarray([r.t_first - r.arrival for r in done
                           if r.t_first is not None])
        ttft = ttft if ttft.size else np.asarray([0.0])
        wait = np.asarray([r.t_admit - r.arrival for r in done
                           if r.t_admit is not None])
        wait = wait if wait.size else np.asarray([0.0])
        return ServeReport(
            finished=len(done), elapsed_s=float(elapsed),
            decoded_tokens=stats.decoded_tokens,
            prefill_tokens=stats.prefill_tokens, steps=stats.steps,
            tokens_per_s=stats.decoded_tokens / max(elapsed, 1e-9),
            token_lat_p50=float(np.percentile(tok, 50)),
            token_lat_p99=float(np.percentile(tok, 99)),
            ttft_p50=float(np.percentile(ttft, 50)),
            ttft_p99=float(np.percentile(ttft, 99)),
            queue_wait_p50=float(np.percentile(wait, 50)),
            queue_wait_p99=float(np.percentile(wait, 99)))


def run_open_loop(loop, requests: Sequence[Request], step_s: float = 1.0,
                  prefill_s: Optional[float] = None,
                  extras_fn=None) -> ServeReport:
    """Replay an open-loop request stream through a continuous-batching
    engine on a virtual clock: each decode step advances ``step_s``,
    each admission's prefill ``prefill_s`` (default ``step_s``).  A
    request joins the running batch the step a slot frees — nobody
    waits for a drain.  ``extras_fn(req)`` supplies per-request model
    extras (audio frames / image tokens) at admission."""
    prefill_s = step_s if prefill_s is None else prefill_s
    reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
    queue = AdmissionQueue()
    now, i = 0.0, 0
    while i < len(reqs) or queue.depth() or not loop.done:
        while i < len(reqs) and reqs[i].arrival <= now + 1e-12:
            queue.push(reqs[i])
            i += 1
        while queue.depth() and loop.free_slots:
            req = queue.pop()
            loop.admit(req, now=now,
                       extras=extras_fn(req) if extras_fn else None)
            now += prefill_s
        if not loop.done:
            loop.decode_step(now=now + step_s)
            now += step_s
        elif not queue.depth() and i < len(reqs):
            now = max(now, reqs[i].arrival)       # idle: jump ahead
    return ServeReport.from_requests(reqs, loop.stats, now)


def run_fixed_batch(loop, requests: Sequence[Request], batch: int,
                    step_s: float = 1.0,
                    prefill_s: Optional[float] = None,
                    extras_fn=None) -> ServeReport:
    """The pre-continuous baseline on the same virtual clock: queue
    until ``batch`` equal-length requests are waiting (or the stream is
    exhausted), prefill them together, decode until the *slowest*
    request finishes, then admit the next batch.  ``extras_fn(reqs)``
    supplies batch-shaped model extras at each batch start."""
    prefill_s = step_s if prefill_s is None else prefill_s
    reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
    queue = AdmissionQueue()
    now, i = 0.0, 0
    current: List[Request] = []
    while i < len(reqs) or queue.depth() or current:
        while i < len(reqs) and reqs[i].arrival <= now + 1e-12:
            queue.push(reqs[i])
            i += 1
        if not current:
            if queue.depth() >= batch or (i >= len(reqs)
                                          and queue.depth()):
                take = min(batch, queue.depth())
                current = [queue.pop() for _ in range(take)]
                for r in current:
                    r.t_admit = now
                loop.start(current,
                           extras=extras_fn(current) if extras_fn
                           else None)
                now += prefill_s * len(current)
            elif i < len(reqs):
                now = max(now, reqs[i].arrival)   # wait for the batch
                continue
        if current:
            loop.decode_step()
            now += step_s
            for r in current:
                if r.out and r.t_first is None:
                    r.t_first = now
                if len(r.out) >= r.max_new_tokens and r.t_done is None:
                    r.t_done = now
            if loop.done:
                current = []
    return ServeReport.from_requests(reqs, loop.stats, now)
