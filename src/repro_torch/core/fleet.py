"""Fleet dynamics: leased hosts that come and go under running gangs.

Faabric's economics (§2.1) only bite if the provider can actually move
capacity between applications — rFaaS (PAPERS.md) models that as
*leased, reclaimable executors*, and Faasm's snapshot-based state is
the recovery mechanism when a lease ends badly.  This module is the
churn side of that story; ``core.snapshot`` + the engine's
checkpoint/requeue machinery are the recovery side.

* ``FleetEvent`` — one timestamped change to the host set:

  - ``join``     new hosts lease in (``capacities`` chips each, optional
                 generation ``speeds``); indices append at the end so
                 running placements never shift.
  - ``reclaim``  a lease ends *with warning*: the hosts drain for
                 ``drain_s`` seconds — no new placements, gangs evacuate
                 gracefully (``PlacementEngine.evacuation_plan`` →
                 ``apply_migration``) — then whatever still holds chips
                 hard-fails.
  - ``fail``     hosts vanish with no warning: every gang touching them
                 is requeued from its last checkpoint, charging the work
                 since that checkpoint as lost.

* ``FleetController`` — applies events to a ``PlacementEngine`` (or
  ``ShardedPlacementEngine``) and returns a ``FleetOutcome`` of pure
  decisions: joined host indices, evacuation plans, stranded gangs,
  failed job_ids.  The *caller* — ``core.simulator``'s event loop, or
  ``core.fabric`` live — owns job/gang state and performs the actual
  moves, requeues and snapshot restores, so simulated and live churn
  share one semantics.

* ``churn_schedule`` — the trace-side regimes the CLI and benchmarks
  compose with arrival traces:

  - ``spot-heavy``                Poisson lease reclaims (short drains)
                                  with like-for-like rejoins — the spot
                                  market.
  - ``steady-join``               capacity arrives steadily over the
                                  trace (a growing reservation), with a
                                  rare hard failure.
  - ``correlated-rack-failure``   a contiguous rack of hosts hard-fails
                                  at once, replaced later by a join.

* checkpoint-interval policy — ``optimal_checkpoint_interval`` is the
  Young/Daly first-order optimum ``tau* = sqrt(2 · delta · MTBF)`` with
  ``delta`` the checkpoint cost (``CostModel.checkpoint_cost_s``) and
  the MTBF estimated from the churn schedule (``churn_mtbf``).  The
  simulator's ``checkpoint_interval`` sweeps cadence against lost work
  (``benchmarks/bench_churn.py``) and the optimum is non-trivial: too
  frequent and the checkpoint overhead dominates, too rare and every
  failure throws away a long tail of work.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import telemetry
from repro_torch.core.placement import Placement, PlacementEngine

# Default drain window for spot reclaims (the cloud's two-minute warning,
# scaled to the simulator's seconds-long jobs).
DEFAULT_DRAIN_S = 5.0

# Drain-deadline evacuation retries: capped exponential backoff.  The
# base/cap are fractions of typical drain windows (a 5 s spot drain gets
# ~3 retries, a 30 s reserved drain ~8) and the deterministic jitter
# de-synchronises concurrent drains in large fleets.
RETRY_BASE_S = 0.5
RETRY_CAP_S = 4.0


@dataclasses.dataclass
class FleetEvent:
    """One timestamped change to the host set (see module docstring)."""

    t: float
    kind: str                                   # join | reclaim | fail
    hosts: List[int] = dataclasses.field(default_factory=list)
    capacities: List[int] = dataclasses.field(default_factory=list)
    speeds: Optional[List[float]] = None        # join only
    drain_s: float = DEFAULT_DRAIN_S            # reclaim only

    def __post_init__(self):
        assert self.kind in ("join", "reclaim", "fail"), self.kind
        if self.kind == "join":
            assert self.capacities, "join needs per-host capacities"
        else:
            assert self.hosts, f"{self.kind} needs target hosts"


@dataclasses.dataclass
class FleetOutcome:
    """Pure decisions from applying one event — the caller moves the
    actual jobs/gangs (requeue, snapshot restore, device churn)."""

    event: FleetEvent
    joined: List[int] = dataclasses.field(default_factory=list)
    evacuations: List[Tuple[str, Placement]] = dataclasses.field(
        default_factory=list)
    stranded: List[str] = dataclasses.field(default_factory=list)
    failed: List[str] = dataclasses.field(default_factory=list)
    deadline: Optional[float] = None            # reclaim only


class FleetController:
    """Applies ``FleetEvent``s to the placement layer.

    One controller per engine; both the simulator's event loop and the
    live ``Fabric`` drive churn through it so lease/drain/fail semantics
    live in exactly one place.  The controller never touches job state:
    it returns plans (``FleetOutcome``) the caller executes."""

    def __init__(self, engine: PlacementEngine):
        self.engine = engine

    def apply(self, ev: FleetEvent, now: float,
              kinds: Optional[Mapping[str, str]] = None) -> FleetOutcome:
        """Apply one event at virtual time ``now``.

        join     -> hosts added; ``joined`` carries the new indices.
        fail     -> allocations dropped; ``failed`` lists the victims to
                    requeue from their last checkpoint.
        reclaim  -> hosts start draining; ``evacuations`` are the
                    graceful moves to apply now (``apply_migration``),
                    ``stranded`` the gangs with nowhere to go, and
                    ``deadline`` when ``expire`` must run.
        """
        out = FleetOutcome(event=ev)
        if ev.kind == "join":
            out.joined = self.engine.add_hosts(ev.capacities, ev.speeds)
        elif ev.kind == "fail":
            out.failed = self.engine.fail_hosts(ev.hosts)
        else:                                   # reclaim
            self.engine.drain_hosts(ev.hosts)
            out.evacuations, out.stranded = self.engine.evacuation_plan(
                ev.hosts, kinds=kinds)
            out.deadline = now + ev.drain_s
        tel = telemetry.get()
        if tel.enabled:
            tel.count(f"fleet.{ev.kind}")
            tel.instant(f"fleet.{ev.kind}", t=now, track="fleet",
                        clock="virtual",
                        hosts=[int(h) for h in (ev.hosts or [])],
                        joined=[int(h) for h in out.joined],
                        failed=list(out.failed),
                        evacuations=len(out.evacuations),
                        stranded=list(out.stranded))
        return out

    def expire(self, ev: FleetEvent,
               kinds: Optional[Mapping[str, str]] = None) -> FleetOutcome:
        """Drain deadline hit: one last-chance evacuation pass (capacity
        may have freed since the reclaim), after which the caller
        applies the moves and then ``fail``s the hosts — whatever still
        holds chips there is requeued from its checkpoint."""
        out = FleetOutcome(event=ev)
        out.evacuations, out.stranded = self.engine.evacuation_plan(
            ev.hosts, kinds=kinds)
        return out

    def fail(self, hosts: Sequence[int]) -> List[str]:
        """Retire ``hosts`` for good (hard failure / drain expiry)."""
        return self.engine.fail_hosts(hosts)

    # retry backoff knobs (module defaults; per-controller overridable)
    retry_base_s = RETRY_BASE_S
    retry_cap_s = RETRY_CAP_S

    def retry_times(self, ev: FleetEvent, now: float) -> List[float]:
        """Evacuation-retry schedule through a reclaim's drain window:
        capped exponential backoff (base doubling up to ``retry_cap_s``)
        with deterministic jitter, strictly inside ``(now, deadline)``.
        Capacity freed mid-drain (a finish, a join) is caught at the
        next retry instead of only at the deadline.  The jitter derives
        from the event's own timestamp and the attempt index — never
        per-process state — so simulator and live runtime (and
        ``predict_trace`` vs ``run_trace``) compute identical schedules,
        while concurrent drains across a large fleet land at different
        offsets instead of thundering-herding the engine."""
        deadline = now + ev.drain_s
        times: List[float] = []
        delay = self.retry_base_s
        t = now
        for k in range(32):             # far beyond any real window
            rng = np.random.default_rng(
                [int(round(ev.t * 1e6)) % (2 ** 31), k, 73])
            t += delay * (1.0 + 0.25 * float(rng.random()))
            if t >= deadline - 1e-9:
                break
            times.append(t)
            delay = min(delay * 2.0, self.retry_cap_s)
        return times


# ---------------------------------------------------------------------------
# Checkpoint-interval policy (Young/Daly)
# ---------------------------------------------------------------------------
def optimal_checkpoint_interval(mtbf_s: float,
                                checkpoint_cost_s: float = 0.5,
                                cost_model=None) -> float:
    """Young/Daly first-order optimum ``tau* = sqrt(2 · delta · MTBF)``.

    ``delta`` is the per-checkpoint cost (``CostModel.checkpoint_cost_s``)
    and ``mtbf_s`` the mean time between failures *as seen by one gang*
    — estimate it from a churn schedule with ``churn_mtbf``.  Checkpoint
    overhead grows as ``delta/tau`` while expected lost work per failure
    grows as ``tau/2``; the product of rates is minimised at ``tau*``.
    Returns ``inf`` for a failure-free fleet (never checkpoint).

    ``cost_model``: a ``CostModel`` to take ``delta`` from instead of
    ``checkpoint_cost_s`` — with delta checkpointing configured
    (``ckpt_delta_fraction``) its amortised
    ``effective_checkpoint_cost_s()`` is cheaper than a full snapshot,
    so the optimum cadence tightens (``sqrt`` of the cost ratio)."""
    if cost_model is not None:
        checkpoint_cost_s = cost_model.effective_checkpoint_cost_s()
    assert checkpoint_cost_s >= 0
    if not math.isfinite(mtbf_s):
        return float("inf")
    return math.sqrt(2.0 * checkpoint_cost_s * mtbf_s)


# ---------------------------------------------------------------------------
# Hazard estimation (per-host / per-group failure rates)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class HazardEstimate:
    """Per-host disruption-rate estimates over a schedule horizon — the
    one estimator both Young/Daly (via ``fleet_mtbf``) and the
    ``CostModel`` risk term's failure-history component consume, so a
    host the cadence policy considers flaky is exactly the host
    placement steers away from."""

    rates: np.ndarray                   # disruptions/s per host
    horizon_s: float
    events_seen: int                    # disruptive events counted

    def host_rate(self, host: int) -> float:
        return float(self.rates[host]) if host < len(self.rates) else 0.0

    def group_rates(self, blast_groups: Sequence[int]
                    ) -> Dict[int, float]:
        """Max per-host rate within each blast-radius group — the
        correlated (one event kills the whole group) view of the same
        estimates."""
        out: Dict[int, float] = {}
        for h, g in enumerate(blast_groups):
            g = int(g)
            r = float(self.rates[h]) if h < len(self.rates) else 0.0
            if r > out.get(g, -1.0):
                out[g] = r
        return out

    def fleet_mtbf(self) -> float:
        """Blast-weighted fleet MTBF: the reciprocal of the mean
        per-host rate — an event killing 2 of 32 hosts disrupts a given
        gang ~1/16th as often as a full-fleet outage (the historical
        ``churn_mtbf`` scalar, re-derived from the per-host rates)."""
        if self.events_seen == 0 or not len(self.rates):
            return float("inf")
        mean = float(self.rates.mean())
        return 1.0 / mean if mean > 0 else float("inf")


def estimate_hazards(events: Sequence[FleetEvent], horizon_s: float,
                     hosts: int) -> HazardEstimate:
    """Per-host disruption rates from a churn schedule: each
    reclaim/fail event counts one disruption against every host it
    targets, over ``horizon_s`` seconds.  Hosts the schedule never
    touches (including join indices past the initial fleet) estimate at
    rate 0."""
    counts = np.zeros(hosts)
    seen = 0
    for e in events:
        if e.kind in ("reclaim", "fail"):
            seen += 1
            for h in e.hosts:
                if 0 <= h < hosts:
                    counts[h] += 1.0
    horizon = max(float(horizon_s), 1e-9)
    return HazardEstimate(rates=counts / horizon, horizon_s=horizon,
                          events_seen=seen)


def churn_mtbf(events: Sequence[FleetEvent], horizon_s: float,
               hosts: int = 0) -> float:
    """MTBF estimate feeding ``optimal_checkpoint_interval`` — a thin
    wrapper over ``estimate_hazards``: mean time between *disruptive*
    events (reclaim/fail) over the horizon, blast-weighted by the
    fraction of the fleet each one takes when ``hosts`` is given.
    ``hosts=0`` keeps the unweighted event spacing.  ``inf`` with no
    disruptions."""
    if hosts:
        return estimate_hazards(events, horizon_s, hosts).fleet_mtbf()
    count = sum(1 for e in events if e.kind in ("reclaim", "fail"))
    if count == 0:
        return float("inf")
    return horizon_s / count


class HazardEstimator:
    """Online per-host failure-rate estimation from *observed*
    ``FleetEvent`` history — the live twin of ``estimate_hazards`` (one
    counts a schedule ahead of time, this one accumulates events as the
    controller applies them; both expose per-host rates).

    ``rate_h(now) = (prior_events + count_h) / max(now, min_horizon_s)``
    — a Laplace-smoothed event rate.  ``prior_events > 0`` gives every
    host a small uniform hazard before any history exists, which
    activates blast-radius correlation from t=0: with all rates equal,
    the risk penalty reduces to the number of blast groups a gang
    touches, so gangs pack within failure domains even before the first
    observed event."""

    def __init__(self, hosts: int, prior_events: float = 0.25,
                 min_horizon_s: float = 1.0):
        self.counts = np.zeros(hosts)
        self.prior_events = float(prior_events)
        self.min_horizon_s = float(min_horizon_s)

    def _ensure(self, hosts: int) -> None:
        if hosts > len(self.counts):
            self.counts = np.concatenate(
                [self.counts, np.zeros(hosts - len(self.counts))])

    def observe(self, ev: FleetEvent) -> None:
        """Record one applied event (joins are not disruptions)."""
        if ev.kind not in ("reclaim", "fail"):
            return
        if ev.hosts:
            self._ensure(max(ev.hosts) + 1)
            for h in ev.hosts:
                self.counts[h] += 1.0

    def rates(self, hosts: int, now: float) -> np.ndarray:
        """Per-host rate estimates sized to the current fleet."""
        self._ensure(hosts)
        horizon = max(float(now), self.min_horizon_s)
        return (self.counts[:hosts] + self.prior_events) / horizon


def lease_expiries(events: Sequence[FleetEvent],
                   hosts: int) -> np.ndarray:
    """Per-host absolute lease-expiry times from a schedule's *reclaim*
    events — the contractual part of churn: a reclaim at ``t`` is the
    lease term the provider sold (rFaaS leases carry their duration),
    so placement may legitimately know it ahead.  Hard ``fail`` events
    are surprises and deliberately NOT included — they reach the risk
    term only through observed hazard history.  ``inf`` = no scheduled
    reclaim (reserved, or a joiner)."""
    out = np.full(hosts, np.inf)
    for e in events:
        if e.kind == "reclaim":
            for h in e.hosts:
                if 0 <= h < hosts:
                    out[h] = min(out[h], e.t)
    return out


def blast_groups(events: Sequence[FleetEvent], hosts: int) -> np.ndarray:
    """Blast-radius group ids from the fleet topology a schedule
    encodes: hosts listed together in one multi-host disruptive event
    share a failure domain (the rack/switch/power the
    correlated-rack generator models — topology an operator knows
    statically), so they union into one group; everything else keeps a
    singleton group.  Group ids are the union-find roots, stable under
    host-index growth."""
    parent = list(range(hosts))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for e in events:
        if e.kind in ("reclaim", "fail") and len(e.hosts) > 1:
            anchor = None
            for h in e.hosts:
                if not 0 <= h < hosts:
                    continue
                if anchor is None:
                    anchor = find(h)
                else:
                    parent[find(h)] = anchor
    return np.array([find(h) for h in range(hosts)], dtype=np.int64)


# ---------------------------------------------------------------------------
# Churn regimes (trace generators)
# ---------------------------------------------------------------------------
CHURN_REGIMES = ("spot-heavy", "steady-join", "correlated-rack-failure")


def churn_schedule(regime: str, hosts: int, chips_per_host: int,
                   horizon: float, seed: int = 0, rate: float = 0.02,
                   drain_s: float = DEFAULT_DRAIN_S,
                   rack: int = 0) -> List[FleetEvent]:
    """Generate a churn schedule composing with an arrival trace.

    ``hosts`` is the fleet size at trace start; joined hosts take fresh
    indices (``hosts``, ``hosts+1``, ...) exactly as
    ``PlacementEngine.add_hosts`` assigns them, so the schedule can be
    replayed on the simulator and the live fabric alike.  ``rate`` is
    the disruptive-event rate (events/second) for the Poisson regimes;
    ``rack`` the correlated-failure blast radius (default: an eighth of
    the fleet, at least 2 hosts).  Deterministic given the seed; events
    never target a host twice, and at least half the initial fleet is
    always left untouched so traces stay schedulable."""
    assert regime in CHURN_REGIMES, regime
    rng = np.random.default_rng([seed, 97])
    events: List[FleetEvent] = []
    removable = list(range(hosts))         # never reclaim a host twice
    rng.shuffle(removable)
    floor = (hosts + 1) // 2               # keep half the fleet stable
    removable = removable[:hosts - floor]

    def take_hosts(k: int) -> List[int]:
        picked, removable[:] = removable[:k], removable[k:]
        return sorted(picked)

    if regime == "spot-heavy":
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / max(rate, 1e-9)))
            if t >= horizon or not removable:
                break
            victims = take_hosts(int(rng.integers(1, 3)))
            if not victims:
                break
            events.append(FleetEvent(t, "reclaim", hosts=victims,
                                     drain_s=drain_s))
            # the spot market gives back: a like-for-like join lands
            # a short lease-turnaround later (capacity roughly conserved)
            delay = float(rng.uniform(2.0, 6.0)) + drain_s
            caps = [chips_per_host] * len(victims)
            events.append(FleetEvent(t + delay, "join",
                                     capacities=caps))
    elif regime == "steady-join":
        # capacity grows steadily over the first 2/3 of the horizon;
        # one rare hard failure keeps recovery honest
        n_joins = max(2, int(horizon * rate))
        for i in range(n_joins):
            t = (i + 1) * (2.0 * horizon / 3.0) / n_joins
            events.append(FleetEvent(t, "join",
                                     capacities=[chips_per_host]))
        if removable:
            t_fail = float(rng.uniform(0.4, 0.6)) * horizon
            events.append(FleetEvent(t_fail, "fail",
                                     hosts=take_hosts(1)))
    else:                                  # correlated-rack-failure
        blast = rack or max(2, hosts // 8)
        blast = min(blast, len(removable))
        # a contiguous run (a rack shares power/switch): pick the start
        # so the rack sits inside the removable half
        start = int(rng.integers(floor, max(floor + 1,
                                            hosts - blast + 1)))
        rack_hosts = list(range(start, min(start + blast, hosts)))
        t_fail = float(rng.uniform(0.25, 0.45)) * horizon
        events.append(FleetEvent(t_fail, "fail", hosts=rack_hosts))
        # the replacement rack leases in after repair
        t_join = t_fail + float(rng.uniform(0.15, 0.3)) * horizon
        events.append(FleetEvent(
            t_join, "join",
            capacities=[chips_per_host] * len(rack_hosts)))
    events.sort(key=lambda e: e.t)
    return events
