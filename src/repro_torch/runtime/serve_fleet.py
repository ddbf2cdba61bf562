"""Virtual serve fleet: the SLO-autoscaling control loop at cluster
scale, in deterministic virtual time.

``ServeFleetSim`` runs the full serving control plane — open-loop
arrivals → ``AdmissionQueue`` → slot-granular virtual serve gangs →
``ServeAutoscaler`` grow/shrink/clone through a real
``PlacementEngine`` — without touching jax, so benchmarks can sweep
offered load and fleet sizes cheaply and the latency/SLO numbers are
exactly reproducible.  Gang capacity comes from
``CostModel.token_latency`` on the gang's *actual placement* (slowest
chip paces the decode step, cross-host slowdown charged per token), so
scaling decisions see the same physics placements are scored with.

``VirtualTrainTenant`` models the elastic training neighbour for the
combined train+serve story: when a serve spike needs chips the tenant
*drains* — it shrinks at its next control point, keeping every unit of
progress — instead of dying (preemption rolls back to the last
checkpoint).  When serve scales back in, the tenant grows again and
backfills the idle chips.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.elastic import ElasticPolicy
from repro_torch.core.placement import CostModel, PlacementEngine
from repro_torch.runtime.admission import (AdmissionQueue, LatencyWindow,
                                     ScaleAction, ServeAutoscaler, ServeSLO)
from repro_torch.runtime.serve_loop import Request


class VirtualServeGang:
    """Slot-level capacity model of one continuous-batching serve gang:
    ``world * slots_per_chip`` slots, one decode step (a token for every
    occupied slot) every ``token_s`` of virtual time."""

    def __init__(self, gang_id: str, world: int, placement,
                 token_s: float, slots_per_chip: int = 1):
        self.gang_id = gang_id
        self.world = world
        self.placement = placement
        self.token_s = token_s
        self.slots_per_chip = slots_per_chip
        self.slots: List[Optional[Tuple[Request, int]]] = \
            [None] * (world * slots_per_chip)
        self.retiring = False
        self._credit = 0.0

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def free_slots(self) -> int:
        if self.retiring:
            return 0
        return len(self.slots) - self.active

    def resize(self, world: int, placement, token_s: float) -> None:
        """Adopt a rescaled placement.  Shrinking never drops an
        in-flight request: occupied lanes above the new capacity drain
        at the new (smaller) gang's pace and their slots retire as they
        free — the continuous engine's drain semantics."""
        self.world = world
        self.placement = placement
        self.token_s = token_s
        want = world * self.slots_per_chip
        occupied = [s for s in self.slots if s is not None]
        free = max(0, want - len(occupied))
        self.slots = occupied + [None] * free

    def admit(self, req: Request, now: float) -> bool:
        for i, s in enumerate(self.slots):
            if s is None and not self.retiring:
                self.slots[i] = (req, req.max_new_tokens)
                req.t_admit = now
                return True
        return False

    def advance(self, dt: float, now: float, queue: AdmissionQueue,
                window: LatencyWindow,
                finished: List[Request]) -> int:
        """Accumulate ``dt`` of decode credit; each whole step decodes
        every occupied lane one token and backfills freed lanes from
        the queue.  Returns tokens decoded."""
        if self.active == 0:
            self._credit = 0.0
            while queue.depth() and self.free_slots:
                self.admit(queue.pop(), now)
            if self.active == 0:
                return 0
        self._credit += dt / self.token_s
        decoded = 0
        while self._credit >= 1.0:
            self._credit -= 1.0
            for i, s in enumerate(self.slots):
                if s is None:
                    continue
                req, rem = s
                if req.t_first is None:
                    req.t_first = now
                req.out.append(0)
                decoded += 1
                rem -= 1
                if rem == 0:
                    req.t_done = now
                    window.record(req)
                    finished.append(req)
                    self.slots[i] = None
                else:
                    self.slots[i] = (req, rem)
            while queue.depth() and self.free_slots:
                self.admit(queue.pop(), now)
            if self.active == 0:
                break
        return decoded


class VirtualTrainTenant:
    """Elastic training neighbour sharing the fleet with serve gangs.

    Progress accrues in chip-seconds of effective parallelism.  A serve
    spike asks for chips via ``drain_to`` — the graceful path: the
    tenant shrinks at its control point with zero lost work.  The
    contrast mode ``preempt`` (kill) rolls progress back to the last
    checkpoint, measuring exactly what drain-not-die saves."""

    def __init__(self, job_id: str, engine: PlacementEngine, world: int,
                 min_world: int = 2, kind: str = "mpi-compute",
                 ckpt_interval_s: float = 8.0):
        self.job_id = job_id
        self.engine = engine
        self.kind = kind
        self.min_world = min_world
        self.max_world = world
        self.ckpt_interval_s = ckpt_interval_s
        self.alloc = engine.allocate(job_id, world, kind=kind)
        assert self.alloc is not None, "train tenant must place at t=0"
        self.progress = 0.0
        self.lost_work = 0.0
        self.backfilled_chip_s = 0.0
        self.last_ckpt_t = 0.0
        self.shrink_events: List[Tuple[float, int, int]] = []

    @property
    def world(self) -> int:
        return 0 if self.alloc is None else self.alloc.n

    def _rate(self) -> float:
        if self.alloc is None:
            return 0.0
        cm = self.engine.cost_model
        eff = cm.effective_parallelism(self.alloc.placement,
                                       self.engine.speeds)
        return eff / cm.slowdown(self.alloc.placement, self.kind)

    def advance(self, dt: float, now: float) -> None:
        self.progress += self._rate() * dt
        if now - self.last_ckpt_t >= self.ckpt_interval_s:
            self.last_ckpt_t = now

    def _reshape(self, new_world: int) -> bool:
        old = self.alloc
        self.engine.release(old)
        alloc = self.engine.allocate(self.job_id, new_world,
                                     kind=self.kind)
        if alloc is None:                       # revert, keep running
            self.alloc = self.engine.allocate(self.job_id, old.n,
                                              kind=self.kind)
            assert self.alloc is not None
            return False
        self.alloc = alloc
        return True

    def drain_to(self, now: float, new_world: int) -> bool:
        """Graceful shrink at a control point: every step so far is
        kept — the victim drains, it does not die."""
        new_world = max(self.min_world, new_world)
        if self.alloc is None or new_world >= self.world:
            return False
        old_world = self.world
        if self._reshape(new_world):
            self.shrink_events.append((now, old_world, new_world))
            return True
        return False

    def preempt(self, now: float, new_world: int) -> bool:
        """Kill-mode contrast: same chips freed, but progress since the
        last checkpoint is lost (what a non-draining preemption costs)."""
        rolled = (now - self.last_ckpt_t) * self._rate()
        if self.drain_to(now, new_world):
            self.progress -= rolled
            self.lost_work += rolled
            return True
        return False

    def try_backfill(self, now: float, policy: ElasticPolicy) -> bool:
        """Grow back into idle chips (the slack serve released)."""
        if self.alloc is None or self.world >= self.max_world:
            return False
        new = policy.decide_scaled(self.world, self.engine, 2.0,
                                   kind=self.kind)
        if new is None or new > self.max_world or new <= self.world:
            return False
        old_world = self.world
        if self._reshape(new):
            self.backfilled_chip_s += (new - old_world) * 1.0
            return True
        return False


@dataclasses.dataclass
class FleetReport:
    finished: int
    decoded_tokens: int
    elapsed_s: float
    tokens_per_s: float
    token_lat_p50: float
    token_lat_p99: float
    slo_target_s: float
    slo_attainment: float           # fraction of requests meeting target
    peak_world: int
    min_world: int
    n_actions: int
    grew: int
    shrank: int
    cloned: int
    timeline: List[Tuple[float, int, int, float]]  # (t, world, qdepth, p99)
    train_progress: float = 0.0
    train_lost_work: float = 0.0
    train_min_world: int = 0
    train_backfilled: float = 0.0


class ServeFleetSim:
    """Deterministic virtual-time fleet: open-loop arrivals feed serve
    gangs whose capacity the ``ServeAutoscaler`` manages through a real
    ``PlacementEngine``; optionally an elastic ``VirtualTrainTenant``
    contends for the same chips (drain-not-die on serve spikes,
    backfill on lulls)."""

    def __init__(self, hosts: int = 4, chips_per_host: int = 8,
                 cost_model: Optional[CostModel] = None,
                 policy: str = "binpack",
                 speeds: Optional[Sequence[float]] = None,
                 slo: Optional[ServeSLO] = None,
                 base_world: int = 2, min_world: int = 1,
                 max_world: int = 16, slots_per_chip: int = 1,
                 target_free: int = 0, cooldown_s: float = 2.0,
                 control_interval_s: float = 1.0, kind: str = "omp"):
        self.cost_model = cost_model or CostModel()
        self.engine = PlacementEngine(hosts, chips_per_host, policy=policy,
                                      speeds=speeds,
                                      cost_model=self.cost_model)
        self.policy = ElasticPolicy(min_world=min_world,
                                    max_world=max_world,
                                    target_free=target_free)
        self.slo = slo or ServeSLO()
        self.scaler = ServeAutoscaler(self.policy, self.engine,
                                      slo=self.slo,
                                      slots_per_chip=slots_per_chip,
                                      base_world=base_world,
                                      cooldown_s=cooldown_s, kind=kind)
        self.slots_per_chip = slots_per_chip
        self.base_world = base_world
        self.kind = kind
        self.control_interval_s = control_interval_s
        self.gangs: Dict[str, VirtualServeGang] = {}
        self.allocs: Dict[str, object] = {}
        self._next_gang = 0

    # ---- gang lifecycle through the engine ---------------------------------
    def _token_s(self, placement) -> float:
        return self.cost_model.token_latency(placement, self.kind,
                                             self.engine.speeds)

    def spawn_gang(self, world: int) -> Optional[VirtualServeGang]:
        gid = f"serve-{self._next_gang}"
        alloc = self.engine.allocate(gid, world, kind=self.kind)
        if alloc is None:
            return None
        self._next_gang += 1
        gang = VirtualServeGang(gid, alloc.n, alloc.placement,
                                self._token_s(alloc.placement),
                                self.slots_per_chip)
        self.gangs[gid] = gang
        self.allocs[gid] = alloc
        return gang

    def _rescale(self, gid: str, world: int) -> bool:
        gang, alloc = self.gangs[gid], self.allocs[gid]
        self.engine.release(alloc)
        new = self.engine.allocate(gid, world, kind=self.kind)
        if new is None:                          # revert
            self.allocs[gid] = self.engine.allocate(gid, alloc.n,
                                                    kind=self.kind)
            assert self.allocs[gid] is not None
            return False
        self.allocs[gid] = new
        gang.resize(new.n, new.placement, self._token_s(new.placement))
        return True

    def _retire(self, gid: str) -> None:
        gang = self.gangs[gid]
        gang.retiring = True
        if gang.active == 0:
            self.engine.release(self.allocs.pop(gid))
            del self.gangs[gid]

    def apply(self, act: ScaleAction) -> None:
        if act.kind == "clone":
            self.spawn_gang(act.world)
        elif act.kind == "grow":
            self._rescale(act.gang_id, act.world)
        elif act.kind == "shrink":
            if act.world <= 0:
                self._retire(act.gang_id)
            else:
                self._rescale(act.gang_id, act.world)

    # ---- the run loop ------------------------------------------------------
    def run(self, requests: Sequence[Request],
            train: Optional[VirtualTrainTenant] = None,
            train_mode: str = "drain",
            tick_s: float = 0.05) -> FleetReport:
        """Replay ``requests`` (arrival-stamped) to completion.  With a
        ``train`` tenant, a failed serve grow/clone asks the tenant for
        chips first (``train_mode``: "drain" keeps its progress,
        "preempt" rolls it back), and every comfortable control tick
        offers idle chips back (backfill)."""
        reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
        if not self.gangs:
            gang = self.spawn_gang(self.base_world)
            assert gang is not None, "fleet too small for base gang"
        queue = AdmissionQueue()
        window = LatencyWindow()
        finished: List[Request] = []
        now, i, decoded = 0.0, 0, 0
        next_control = 0.0
        timeline: List[Tuple[float, int, int, float]] = []
        peak_w, min_w = 0, 10 ** 9
        train_min_world = train.world if train is not None else 0
        grew = shrank = cloned = 0
        while i < len(reqs) or queue.depth() \
                or any(g.active for g in self.gangs.values()):
            now = round(now + tick_s, 9)
            while i < len(reqs) and reqs[i].arrival <= now:
                queue.push(reqs[i])
                i += 1
            for gid in sorted(self.gangs):
                decoded += self.gangs[gid].advance(tick_s, now, queue,
                                                   window, finished)
            if train is not None:
                train.advance(tick_s, now)
            for gid in [g for g, gang in self.gangs.items()
                        if gang.retiring and gang.active == 0]:
                self.engine.release(self.allocs.pop(gid))
                del self.gangs[gid]
            if now >= next_control:
                next_control = now + self.control_interval_s
                worlds = {g: gang.world
                          for g, gang in self.gangs.items()
                          if not gang.retiring}
                acts = self.scaler.decide(now, queue.depth(),
                                          window.p99, worlds)
                for act in acts:
                    if act.kind == "need":
                        # pool exhausted: reclaim chips from the
                        # elastic training tenant, then retry the grow.
                        # "drain" keeps the tenant's progress (it
                        # shrinks at this control point); "preempt" is
                        # the kill-mode contrast that rolls it back.
                        if train is None:
                            continue
                        want = max(train.min_world, train.world // 2)
                        gave = (train.drain_to(now, want)
                                if train_mode == "drain"
                                else train.preempt(now, want))
                        if gave and act.gang_id in self.gangs \
                                and self._rescale(act.gang_id,
                                                  act.world):
                            grew += 1
                        continue
                    before = len(self.gangs)
                    chips = sum(g.world for g in self.gangs.values())
                    self.apply(act)
                    after_chips = sum(g.world
                                      for g in self.gangs.values())
                    if act.kind == "clone" and len(self.gangs) > before:
                        cloned += 1
                    elif act.kind == "grow" and after_chips > chips:
                        grew += 1
                    elif act.kind == "shrink":
                        shrank += 1
                if train is not None:
                    train_min_world = min(train_min_world, train.world)
                    if not acts:
                        train.try_backfill(now, self.policy)
                total_world = sum(g.world for g in self.gangs.values())
                peak_w = max(peak_w, total_world)
                min_w = min(min_w, total_world)
                timeline.append((now, total_world, queue.depth(),
                                 window.p99 or 0.0))
        elapsed = max(now, 1e-9)
        done = [r for r in reqs if r.t_done is not None and r.out]
        lat = np.asarray([(r.t_done - r.arrival) / len(r.out)
                          for r in done]) if done else np.asarray([0.0])
        attain = float(np.mean(lat <= self.slo.target_p99_s)) \
            if done else 0.0
        return FleetReport(
            finished=len(done), decoded_tokens=decoded,
            elapsed_s=elapsed,
            tokens_per_s=decoded / elapsed,
            token_lat_p50=float(np.percentile(lat, 50)),
            token_lat_p99=float(np.percentile(lat, 99)),
            slo_target_s=self.slo.target_p99_s,
            slo_attainment=attain,
            peak_world=peak_w, min_world=min_w,
            n_actions=len(self.scaler.actions),
            grew=grew, shrank=shrank, cloned=cloned,
            timeline=timeline,
            train_progress=train.progress if train else 0.0,
            train_lost_work=train.lost_work if train else 0.0,
            train_min_world=train_min_world,
            train_backfilled=train.backfilled_chip_s if train else 0.0)
