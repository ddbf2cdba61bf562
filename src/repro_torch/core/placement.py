"""Policy-driven gang placement on a shared cluster (paper §3.4, §6.2).

This is the single code path behind every placement decision in the repo:
the discrete-event simulator (paper Fig 10/11/14), the live runtime's
sub-mesh carving / rescale / migrate control-point actions, and the
scheduler facade in ``core.scheduler``.  The split is:

* ``CostModel`` — the one job-time model every layer consumes::

      T = (W / Σ_h n_h·s_h) · (1 + beta_kind · chi)

  with per-host speed factors ``s_h`` (mixed host generations) and a
  per-job-kind cross-host penalty ``beta`` calibrated from the paper's
  Fig 14 microbenchmarks (compute-bound 0.4, network-bound 13.0).
  Policies rank candidate placements by it, the simulator's job rates
  integrate it, and the engine's migration/preemption plans cost moves
  with it — so simulated and live decisions stay placement-for-placement
  identical.

* ``PlacementPolicy`` — a pure function from a free-chip snapshot
  (``ClusterView``) to a gang placement ``[(host, n_chips)]``.  Shipped
  policies:

  - ``binpack``      Faabric's default: greedy most-free-first so the gang
                     spans as few hosts as possible (the seed behaviour);
                     on heterogeneous fleets "most free" is measured in
                     effective throughput ``free_h·s_h``.
  - ``spread``       round-robin chips over hosts (load balancing),
                     throughput-weighted on heterogeneous fleets.
  - ``fixed-slice``  the §6.2 k-containers-per-VM baselines: whole slices
                     of ``slice_size`` chips, never shared between jobs.
  - ``locality``     scores candidate placements by the full predicted
                     ``T`` of the cost model and picks the minimiser,
                     tie-breaking on chips stranded on touched hosts
                     (best-fit) so large contiguous blocks survive for
                     later gangs.  On homogeneous fleets ``Σ n_h·s_h``
                     is constant across candidates, so the score
                     degenerates to the slowdown ``(1 + beta·chi)``
                     exactly as before the CostModel refactor.

* ``PlacementEngine`` — owns the mutable cluster state: free-chip
  accounting, gang allocation, preemption-safe reservations (hold chips
  before binding a job so multi-step decisions are atomic), migration
  planning at barrier points, and adoption of externally-created
  placements (``bind``, used by the live runtime).  Hosts default to
  ``chips_per_host`` chips each; ``capacities`` overrides per-host chip
  counts (a ragged last host on the CPU fabric) and ``speeds`` carries
  per-host speed factors (mixed host generations).

* ``PreemptPolicy`` — victim selection when a high-priority arrival
  cannot be placed: evict the cheapest set of strictly-lower-priority
  gangs (checkpoint + requeue is the *caller's* job — the engine only
  plans).  Used by the simulator's priority traces and by
  ``core.fabric.Fabric`` for live preemption.

* ``ShardedPlacementEngine`` — the decentralised scheduler (Fig 11 fix):
  the fleet is partitioned into host-group shards; a placement decision
  consults a cheap per-shard summary index (idle chips, idle
  throughput, max contiguous free block) and then runs the policy on
  the chosen shard's O(hosts_per_shard) slice only, forwarding to other
  shards (counted as ``decision_hops``) when the home shard cannot fit
  the gang.  With one shard covering the whole fleet every decision is
  bit-identical to the centralised ``PlacementEngine``.

The placement hot path (host ordering, greedy fills, candidate scoring)
is vectorized with numpy; the original pure-Python loops survive under
``reference_loops()`` so parity tests and the scheduler-scale benchmark
can A/B the exact pre-vectorization behaviour.

**Fleet churn** (``core.fleet`` drives it): the host set is no longer
immutable after construction.  ``add_hosts`` leases new hosts into the
fleet, ``drain_hosts`` begins a lease reclaim (the host takes no new
placements; its free chips are returned to the provider immediately and
held chips follow as gangs leave), ``fail_hosts`` is a hard failure
(every gang touching a failed host loses its allocation — the caller
requeues it from its last checkpoint), and ``evacuation_plan`` plans
moves off doomed hosts (the graceful-drain path, applied through the
same ``apply_migration`` machinery as barrier migration).  With no
churn (``draining`` never set, host count constant) every decision is
bit-identical to the pre-churn engine — pinned by tests.

**Risk-aware placement** (DESIGN.md §13): the engine carries per-host
lease-expiry times, online hazard estimates (fed from observed
``FleetEvent`` history via ``core.fleet.HazardEstimator``), and
blast-radius group ids.  With ``CostModel.risk_tau_s`` opted in, views
grow a ``RiskContext`` and every policy steers gangs away from
short-lease / historically-flaky hosts in proportion to the expected
lost work of landing there (blast-correlated hazard × half a
checkpoint interval); per-kind ``risk_weights`` let cheap restartable
work soak up risky capacity at weight 0.  Default-off keeps every
decision bit-identical to the risk-blind engine — pinned by tests.
``shrink_plan`` is the recovery half: the largest shrunken world of a
stranded gang that still fits on surviving capacity, tried before any
checkpoint rollback.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import (Dict, List, Mapping, Optional, Sequence, Tuple, Union)

import numpy as np

from repro_torch.core import comms, telemetry

Placement = List[Tuple[int, int]]          # [(host, n_chips)] sorted

# Default host-group size for the sharded engine: the latency sweet spot
# in the Fig 11 regime (a 128-host fleet becomes 8 shards of 16).
DEFAULT_SHARD_HOSTS = 16


def auto_shard_hosts(hosts: int) -> int:
    """Adaptive shard size: ``hosts_per_shard ~ sqrt(2 * hosts)``.

    One decision pays ``O(hosts_per_shard)`` to scan its shard plus
    ``O(hosts / hosts_per_shard)`` summary-index entries when it has to
    forward — the sum is minimised at the square root, and the factor 2
    calibrates the optimum to the Fig 11 sweet spot measured in the
    scheduler-scale benchmark (128 hosts -> 16-host shards).  The
    sharded engine recomputes this as churn changes the live host count
    when built with ``hosts_per_shard="auto"``."""
    return max(2, min(hosts, int(round(math.sqrt(2.0 * hosts)))))

# When False, the placement hot path runs the original pre-vectorization
# implementation: pure-Python per-host/per-chip fill loops, per-call
# policy re-resolution, copied views, and per-call O(hosts) summary
# recomputation instead of the incremental counters.  Decisions are
# bit-identical either way (pinned by tests); the flag exists so
# bench_scheduler_scale can measure the speedup against the real pre-PR
# implementation and so a parity failure would be directly bisectable.
_VECTORIZED = True


@contextlib.contextmanager
def reference_loops():
    """Run the placement hot path on the pre-vectorization loop
    implementation (A/B baseline for benchmarks and parity tests)."""
    global _VECTORIZED
    prev = _VECTORIZED
    _VECTORIZED = False
    try:
        yield
    finally:
        _VECTORIZED = prev


def placement_cross_host_fraction(placement: Sequence[Tuple[int, int]]
                                  ) -> float:
    """chi = P[two random ranks sit on different hosts] — the collective
    slow-path fraction used by the simulator's time model."""
    n = sum(c for _, c in placement)
    if n <= 1:
        return 0.0
    return 1.0 - sum((c / n) ** 2 for _, c in placement)


def _chi_batch(placements: Sequence[Sequence[Tuple[int, int]]]
               ) -> np.ndarray:
    """Vectorized ``placement_cross_host_fraction`` over a batch: one
    flattened bincount pass.  Per-candidate accumulation order matches
    the Python generator sum (flat order), so values are bit-identical."""
    k = len(placements)
    sizes = np.array([len(p) for p in placements])
    chips = np.array([c for p in placements for _, c in p],
                     dtype=np.float64)
    seg = np.repeat(np.arange(k), sizes)
    n = np.bincount(seg, weights=chips, minlength=k)
    frac_sq = (chips / n[seg]) ** 2
    return np.where(n > 1, 1.0 - np.bincount(seg, weights=frac_sq,
                                             minlength=k), 0.0)


def derive_capacities(n_chips: int, chips_per_host: int) -> List[int]:
    """Per-host chip capacities for a pool of ``n_chips`` devices: hosts
    are consecutive runs of ``chips_per_host`` chips, and the last host
    carries the ragged remainder.  The one place the host map is derived
    — ``Fabric`` and ``PlacementEngine.for_chips`` both use it."""
    assert n_chips > 0 and chips_per_host > 0
    hosts = -(-n_chips // chips_per_host)
    return [min(chips_per_host, n_chips - h * chips_per_host)
            for h in range(hosts)]


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------
class CostModel:
    """The §6 job-time model ``T = (W / Σ_h n_h·s_h)·(1 + beta_kind·chi)``.

    Calibration (paper Fig 14, §6.4):

    ==============  =====  ==========================================
    job kind        beta   source
    ==============  =====  ==========================================
    mpi-compute      0.4   LAMMPS co-located vs 4+4-fragmented = 1.2x
    mpi-network     13.0   all-to-all fragmented = 7.5x
    omp              1.0   shared-memory intermediate
    ==============  =====  ==========================================

    ``speeds`` (per-host factors ``s_h``, 1.0 = current generation) turn
    the perfect-scaling term ``W/n`` into ``W / Σ_h n_h·s_h``; with no
    speeds (homogeneous fleet) every method reduces bit-exactly to the
    pre-heterogeneity formulas.  ``migrate_progress_cap`` is Fig 14's
    migration-worthwhile heuristic: past this progress fraction the
    snapshot transfer no longer pays for itself; ``migration_cost_s``
    is that snapshot-transfer cost (the simulator's MIGRATION_COST_S),
    which a heterogeneous migration's predicted saving must exceed.
    """

    DEFAULT_BETAS: Dict[str, float] = {"mpi-compute": 0.4,
                                       "mpi-network": 13.0, "omp": 1.0}

    def __init__(self, betas: Optional[Mapping[str, float]] = None,
                 default_beta: float = 0.4,
                 migrate_progress_cap: float = 0.8,
                 migration_cost_s: float = 2.0,
                 preempt_cost_s: float = 2.0,
                 checkpoint_cost_s: float = 0.5,
                 ckpt_delta_fraction: Optional[float] = None,
                 ckpt_rebase_every: int = 8,
                 collective_bytes: Union[None, float,
                                         Mapping[str, float]] = None,
                 step_compute_s: float = 1.0,
                 link: Optional[comms.LinkProfile] = None,
                 compress_frac: float = 0.05,
                 serve_token_s: float = 0.05,
                 serve_slo_s: Optional[float] = None,
                 serve_kinds: Sequence[str] = ("omp", "serve"),
                 risk_tau_s: Optional[float] = None,
                 risk_weights: Optional[Mapping[str, float]] = None,
                 default_risk_weight: float = 1.0,
                 risk_lease_floor_s: float = 1.0):
        self.betas = dict(self.DEFAULT_BETAS if betas is None else betas)
        self.default_beta = default_beta
        # serve SLO term: ``serve_token_s`` is the base per-token decode
        # latency of a serve gang on reference chips; with
        # ``serve_slo_s`` set (opt-in, like collective_bytes), ``score``
        # / ``score_batch`` multiply a latency-violation penalty into
        # candidates for ``serve_kinds`` jobs so placement spreads serve
        # gangs onto topologies that can hold the SLO.  The penalty
        # deliberately does NOT enter ``slowdown`` — that feeds the
        # simulated execution rate, and an SLO preference must steer
        # *choices*, not rewrite physics.  None keeps every decision
        # bit-identical to the unpenalised model.
        self.serve_token_s = float(serve_token_s)
        self.serve_slo_s = serve_slo_s
        self.serve_kinds = tuple(serve_kinds)
        # collective-aware pricing (DESIGN.md §11): when
        # ``collective_bytes`` is set (bytes per sync step, scalar or
        # per-kind map), ``slowdown`` prices the *best achievable*
        # collective schedule on the candidate's topology
        # (``collective_time``) against ``step_compute_s`` of compute,
        # instead of the scalar ``beta·chi``.  None (the default) keeps
        # every decision bit-identical to the scalar model — the opt-in
        # gate that preserves the pinned placement tests.
        self.collective_bytes = collective_bytes
        self.step_compute_s = float(step_compute_s)
        self.link = link or comms.LinkProfile()
        self.compress_frac = float(compress_frac)
        self.migrate_progress_cap = migrate_progress_cap
        self.migration_cost_s = migration_cost_s
        self.preempt_cost_s = preempt_cost_s
        # periodic-checkpoint cost (a snapshot save, cheaper than the
        # cross-host transfer of migration_cost_s): what the simulator
        # charges per checkpoint under a checkpoint_interval policy and
        # the delta feeding the Young/Daly optimum in core.fleet
        self.checkpoint_cost_s = checkpoint_cost_s
        # delta checkpointing (core.diffsync chains): a delta save costs
        # ``ckpt_delta_fraction`` of a full one, with a full rebase every
        # ``ckpt_rebase_every`` checkpoints to bound the replay chain.
        # The fraction is *configured* (a deterministic parameter), so
        # predicted and live traces charge identically and Action logs
        # stay bit-equal; live-measured bytes land in ``ckpt_observed``
        # and live-measured step times in ``step_observed``
        # via ``observe_checkpoint`` as statistics only, to calibrate
        # the next run's fraction — never consumed mid-trace.
        # None keeps the pre-delta behaviour: every checkpoint is full.
        self.ckpt_delta_fraction = ckpt_delta_fraction
        self.ckpt_rebase_every = max(1, int(ckpt_rebase_every))
        self.ckpt_observed: List[Tuple[int, int]] = []
        self.step_observed: Dict[Tuple[str, Optional[str]],
                                 List[float]] = {}
        # risk term (DESIGN.md §13): with ``risk_tau_s`` set (the gang
        # checkpoint cadence, opt-in like collective_bytes /
        # serve_slo_s), ``score``-consuming policies multiply candidates
        # by the expected lost work of placing there — per-host hazard
        # (lease expiry + observed failure rate, correlated across a
        # blast-radius group) times half a checkpoint interval of
        # rollback.  ``risk_weights`` scales the term per job kind
        # (weight 0 = restartable work that happily soaks up risky
        # capacity).  Like the serve SLO term it deliberately does NOT
        # enter ``slowdown`` — risk steers *choices*, not physics.
        # None (the default) keeps every decision bit-identical.
        self.risk_tau_s = risk_tau_s
        self.risk_weights = (None if risk_weights is None
                             else dict(risk_weights))
        self.default_risk_weight = float(default_risk_weight)
        self.risk_lease_floor_s = float(risk_lease_floor_s)

    # ---- delta-checkpoint costs (core.diffsync chains) --------------------
    def checkpoint_cost(self, index: int = 0) -> float:
        """Cost of the ``index``-th periodic checkpoint of a run segment
        (index 0 = the baseline taken at start).  Rebase points —
        every ``ckpt_rebase_every``-th — pay the full snapshot cost;
        the checkpoints between them ship deltas."""
        if self.ckpt_delta_fraction is None:
            return self.checkpoint_cost_s
        if index % self.ckpt_rebase_every == 0:
            return self.checkpoint_cost_s
        return self.checkpoint_cost_s * self.ckpt_delta_fraction

    def effective_checkpoint_cost_s(
            self, fraction: Optional[float] = None) -> float:
        """Amortised per-checkpoint cost over one rebase period — the
        ``delta`` that ``fleet.optimal_checkpoint_interval`` (Young/Daly)
        consumes, so cheaper delta checkpoints buy a tighter cadence.
        ``fraction`` overrides the configured ``ckpt_delta_fraction``
        with a *measured* one (``observed_delta_fraction``) — the live
        runner's adaptive cadence re-derives its Young/Daly interval
        from it after each rebase window."""
        frac = self.ckpt_delta_fraction if fraction is None else fraction
        if frac is None:
            return self.checkpoint_cost_s
        r = self.ckpt_rebase_every
        return self.checkpoint_cost_s * (1.0 + (r - 1) * frac) / r

    def observe_checkpoint(self, delta_bytes: int, full_bytes: int) -> None:
        """Record one live checkpoint's measured (shipped, full) bytes.
        Statistics only: the trace keeps charging the configured
        fraction so live Action logs match ``predict_trace``."""
        self.ckpt_observed.append((int(delta_bytes), int(full_bytes)))

    def observed_delta_fraction(self) -> Optional[float]:
        """Measured Σdelta/Σfull over the observed checkpoints — the
        calibrated ``ckpt_delta_fraction`` for the *next* run."""
        if not self.ckpt_observed:
            return None
        full = sum(f for _, f in self.ckpt_observed)
        if full <= 0:
            return None
        return sum(d for d, _ in self.ckpt_observed) / full

    def observe_step(self, host_kind: str, job_kind: Optional[str],
                     step_s: float, count: int = 1) -> None:
        """Record measured wall step time for (host-kind, job-kind) —
        the telemetry plane's calibration feed (ROADMAP item 2).
        Statistics only, like ``observe_checkpoint``: predictions keep
        using the configured tables so pinned traces stay bit-equal;
        the *next* run may fit ``step_compute_s`` / speed factors from
        ``observed_step_times``."""
        key = (str(host_kind), job_kind if job_kind is None
               else str(job_kind))
        agg = self.step_observed.setdefault(key, [0, 0.0])
        agg[0] += int(count)
        agg[1] += float(step_s) * int(count)

    def observed_step_times(self) -> Dict[Tuple[str, Optional[str]],
                                          Tuple[int, float]]:
        """(host_kind, job_kind) -> (count, mean measured seconds)."""
        return {k: (int(v[0]), v[1] / v[0])
                for k, v in self.step_observed.items() if v[0]}

    def observed_step_time(self, host_kind: Optional[str] = None,
                           job_kind: Optional[str] = None
                           ) -> Optional[float]:
        """Mean measured step time over matching observations (either
        key may be None = any)."""
        n, tot = 0, 0.0
        for (hk, jk), (c, s) in self.step_observed.items():
            if host_kind is not None and hk != host_kind:
                continue
            if job_kind is not None and jk != job_kind:
                continue
            n += c
            tot += s
        return (tot / n) if n else None

    def beta(self, kind: Optional[str] = None) -> float:
        """Per-job-kind cross-host penalty; ``default_beta`` when the
        kind is unknown (e.g. a live gang with no trace kind)."""
        if kind is None:
            return self.default_beta
        return self.betas.get(kind, self.default_beta)

    @property
    def collective_pricing(self) -> bool:
        return self.collective_bytes is not None

    def sync_bytes(self, kind: Optional[str] = None) -> float:
        """Per-step collective message size for a job kind (scalar
        config applies to every kind)."""
        cb = self.collective_bytes
        if cb is None:
            return 0.0
        if isinstance(cb, Mapping):
            return float(cb.get(kind, cb.get(None, comms.DEFAULT_NBYTES)))
        return float(cb)

    def collective_time(self, placement: Sequence[Tuple[int, int]],
                        nbytes: Optional[float] = None,
                        kind: Optional[str] = None) -> float:
        """Seconds per sync step under the *best achievable* collective
        schedule (flat/ring/hierarchical/compressed) on this
        placement's topology — what the comms-layer ``CollectiveTuner``
        would actually dispatch (``core.comms`` pricing).  Unlike the
        scalar ``beta·chi`` this distinguishes balanced from ragged
        splits: the hierarchical slow hop ships ``bytes/min_fast``, so
        (4,4) prices cheaper than (6,2) at equal chi-ish spread."""
        if nbytes is None:
            nbytes = self.sync_bytes(kind) or comms.DEFAULT_NBYTES
        topo = comms.Topology.from_placement(placement)
        _, t = comms.best_schedule(topo, int(nbytes), self.link,
                                   self.compress_frac)
        return t

    def slowdown(self, placement: Sequence[Tuple[int, int]],
                 kind: Optional[str] = None) -> float:
        """``1 + beta_kind·chi`` for a placement — or, with collective
        pricing enabled, ``1 + collective_time/step_compute_s`` (the
        measured-schedule generalisation of the same ratio)."""
        if self.collective_bytes is not None:
            return 1.0 + (self.collective_time(placement, kind=kind)
                          / max(self.step_compute_s, 1e-12))
        return 1.0 + self.beta(kind) * placement_cross_host_fraction(
            placement)

    def effective_parallelism(self, placement: Sequence[Tuple[int, int]],
                              speeds: Optional[np.ndarray] = None,
                              active: Optional[int] = None) -> float:
        """``Σ_h n_h·s_h`` — chips weighted by host speed.  ``active``
        caps the working ranks below the allocated chips (an OpenMP job
        in an over-large container); the speed-weighted sum then scales
        by the active fraction."""
        n = sum(c for _, c in placement)
        if active is None:
            active = n
        if speeds is None:
            return float(active)
        eff = float(sum(c * float(speeds[h]) for h, c in placement))
        if active != n and n > 0:
            eff *= active / n
        return eff

    def predicted_time(self, work: float,
                       placement: Sequence[Tuple[int, int]],
                       kind: Optional[str] = None,
                       speeds: Optional[np.ndarray] = None,
                       active: Optional[int] = None) -> float:
        """``T = (W / Σ_h n_h·s_h)·(1 + beta_kind·chi)``."""
        eff = self.effective_parallelism(placement, speeds, active)
        if eff <= 0:
            return float("inf")
        return (work / eff) * self.slowdown(placement, kind)

    def token_latency(self, placement: Sequence[Tuple[int, int]],
                      kind: Optional[str] = None,
                      speeds: Optional[np.ndarray] = None) -> float:
        """Predicted per-token decode latency of a serve gang on this
        placement: the replicated decode step is paced by the slowest
        participating chip and pays the gang's cross-host / collective
        slowdown on every token."""
        if not placement:
            return float("inf")
        smin = 1.0 if speeds is None else min(float(speeds[h])
                                              for h, _ in placement)
        return (self.serve_token_s * self.slowdown(placement, kind)
                / max(smin, 1e-12))

    def serve_slo_penalty(self, placement: Sequence[Tuple[int, int]],
                          kind: Optional[str] = None,
                          speeds: Optional[np.ndarray] = None) -> float:
        """Multiplicative score penalty for serve-kind placements whose
        predicted ``token_latency`` breaks ``serve_slo_s`` (1.0 when the
        SLO holds, the violation ratio when it doesn't, 1.0 always when
        the term is not opted in)."""
        if self.serve_slo_s is None or kind not in self.serve_kinds:
            return 1.0
        lat = self.token_latency(placement, kind, speeds)
        return max(1.0, lat / self.serve_slo_s)

    def score(self, placement: Sequence[Tuple[int, int]],
              kind: Optional[str] = None,
              speeds: Optional[np.ndarray] = None) -> float:
        """Per-unit-work predicted ``T`` — what policies rank candidate
        placements by (``W`` is constant across candidates, so it drops
        out of the argmin).  With ``serve_slo_s`` opted in, serve-kind
        candidates that would break the token-latency SLO are scaled by
        the violation ratio."""
        return (self.predicted_time(1.0, placement, kind, speeds)
                * self.serve_slo_penalty(placement, kind, speeds))

    def score_batch(self, placements: Sequence[Sequence[Tuple[int, int]]],
                    kind: Optional[str] = None,
                    speeds: Optional[np.ndarray] = None) -> np.ndarray:
        """Vectorized ``score`` over a batch of candidate placements:
        one flattened numpy pass over all (host, chips) pairs instead of
        a Python reduction per candidate.  The per-candidate float
        operation order matches ``score`` (chi accumulates ``(c/n)**2``
        terms, then ``(1/eff) * slowdown``), so ranking candidates by
        either form agrees."""
        k = len(placements)
        if k == 0:
            return np.empty(0, dtype=np.float64)
        if self.collective_bytes is not None:
            # collective pricing walks each candidate's topology; the
            # candidate sets policies score are tiny (<= 5), so the
            # scalar path is fine here
            return np.array([self.score(p, kind, speeds)
                             for p in placements], dtype=np.float64)
        sizes = np.array([len(p) for p in placements])
        hosts = np.array([h for p in placements for h, _ in p],
                         dtype=np.int64)
        chips = np.array([c for p in placements for _, c in p],
                         dtype=np.float64)
        seg = np.repeat(np.arange(k), sizes)
        n = np.bincount(seg, weights=chips, minlength=k)
        frac_sq = (chips / n[seg]) ** 2
        chi = np.where(n > 1, 1.0 - np.bincount(seg, weights=frac_sq,
                                                minlength=k), 0.0)
        slowdown = 1.0 + self.beta(kind) * chi
        if speeds is None:
            eff = n
        else:
            eff = np.bincount(seg, weights=chips * speeds[hosts],
                              minlength=k)
        safe = np.where(eff > 0, eff, 1.0)
        out = np.where(eff > 0, (1.0 / safe) * slowdown, np.inf)
        if self.serve_slo_s is not None and kind in self.serve_kinds:
            # same formula as serve_slo_penalty, segmented: the decode
            # step is paced by the slowest chip in each candidate
            if speeds is None:
                smin = np.ones(k)
            else:
                smin = np.full(k, np.inf)
                np.minimum.at(smin, seg, speeds[hosts])
            lat = (self.serve_token_s * slowdown
                   / np.maximum(smin, 1e-12))
            out = out * np.maximum(1.0, lat / self.serve_slo_s)
        return out

    def active_workers(self, parallelism: int, alloc_n: int,
                       shared_memory: bool) -> int:
        """Working ranks on an allocation: OpenMP threads in one
        container cap at the container's chips (§6.2); MPI world sizes
        are fixed at submission."""
        return min(parallelism, alloc_n) if shared_memory else parallelism

    def migration_worthwhile(self, progress: float) -> bool:
        """Fig 14: consolidation pays off except near the finish line."""
        return progress <= self.migrate_progress_cap

    # ---- risk term (leases / failure history; DESIGN.md §13) --------------
    @property
    def risk_aware(self) -> bool:
        return self.risk_tau_s is not None

    def risk_weight(self, kind: Optional[str] = None) -> float:
        """Per-job-kind sensitivity to host risk.  High-priority or
        expensive-to-checkpoint kinds keep the default weight; cheap
        restartable kinds can be configured at 0 so they soak up risky
        capacity instead of competing for safe hosts."""
        if not self.risk_aware:
            return 0.0
        if self.risk_weights is None:
            return self.default_risk_weight
        return float(self.risk_weights.get(kind,
                                           self.default_risk_weight))

    def risk_loss_s(self) -> float:
        """Expected seconds lost per gang-wide disruption: on average
        half a checkpoint interval of progress rolls back, plus the
        requeue/restart overhead — the lost-work magnitude the hazard
        rate multiplies in the risk penalty."""
        return (self.risk_tau_s or 0.0) / 2.0 + self.preempt_cost_s


@dataclasses.dataclass
class Allocation:
    job_id: str
    placement: Placement
    slice_size: int = 0                     # 0 = granular

    @property
    def n(self) -> int:
        return sum(c for _, c in self.placement)

    @property
    def hosts(self) -> List[int]:
        return [h for h, _ in self.placement]

    def fragmentation(self) -> int:
        return len(self.placement)

    def cross_host_fraction(self) -> float:
        return placement_cross_host_fraction(self.placement)


class RiskContext:
    """Per-host risk snapshot handed to policies inside a ``ClusterView``
    (attached by the engine only when its cost model opted into the risk
    term, so risk-blind decisions never see one — bit-identity).

    The combined per-host hazard rate is

        rate_h = hazard_h + 1 / max(lease_until_h - now, lease_floor)

    — the online failure-rate estimate from observed ``FleetEvent``
    history plus the certain disruption of an approaching lease expiry
    (an infinite lease contributes 0).  A gang placement's disruption
    rate correlates hazards across blast-radius groups: any host of a
    group failing kills the whole gang, and failures *within* a group
    are one event (shared rack/switch/power), so

        Lambda(P) = sum over groups g touched by P of max rate_h, h in g∩P

    — spanning extra groups adds independent failure sources; packing
    deeper into one already-touched group costs nothing extra.  The
    score penalty is ``1 + w_kind · Lambda(P) · risk_loss_s`` (expected
    lost-work fraction), and greedy policies order hosts by the
    risk-discounted effective throughput ``free·s / (1 + w·rate·loss)``.
    """

    __slots__ = ("model", "lease_until_s", "hazards", "blast_group",
                 "now", "_rates")

    def __init__(self, model: CostModel, lease_until_s: np.ndarray,
                 hazards: np.ndarray, blast_group: np.ndarray,
                 now: float, rates: Optional[np.ndarray] = None):
        self.model = model
        self.lease_until_s = lease_until_s
        self.hazards = hazards
        self.blast_group = blast_group
        self.now = now
        self._rates = rates

    def rates(self) -> np.ndarray:
        """Combined per-host disruption rate (cached per context)."""
        if self._rates is None:
            left = self.lease_until_s - self.now
            lease_rate = np.where(
                np.isfinite(self.lease_until_s),
                1.0 / np.maximum(left, self.model.risk_lease_floor_s),
                0.0)
            self._rates = self.hazards + lease_rate
        return self._rates

    def sliced(self, lo: int, hi: int) -> "RiskContext":
        """Shard-slice view of the same snapshot (local host indices)."""
        return RiskContext(self.model, self.lease_until_s[lo:hi],
                           self.hazards[lo:hi], self.blast_group[lo:hi],
                           self.now, rates=self.rates()[lo:hi])

    def discounts(self, kind: Optional[str] = None) -> Optional[np.ndarray]:
        """Per-host multiplicative discount ``1/(1 + w·rate·loss)`` for
        greedy host ordering; None when the kind is risk-indifferent
        (weight 0) so its decisions keep the exact risk-blind path."""
        w = self.model.risk_weight(kind)
        if w <= 0.0:
            return None
        return 1.0 / (1.0 + w * self.rates() * self.model.risk_loss_s())

    def order_speeds(self, kind: Optional[str],
                     speeds: Optional[np.ndarray]) -> Optional[np.ndarray]:
        """Risk-discounted speed factors for ``_host_order`` — ordering
        only, never fed to any charged quantity (choices, not physics)."""
        disc = self.discounts(kind)
        if disc is None:
            return None
        return disc if speeds is None else speeds * disc

    def gang_rate(self, placement: Sequence[Tuple[int, int]]) -> float:
        """Blast-correlated disruption rate Lambda(P) of a placement."""
        rates = self.rates()
        worst: Dict[int, float] = {}
        for h, _ in placement:
            g = int(self.blast_group[h])
            r = float(rates[h])
            if r > worst.get(g, -1.0):
                worst[g] = r
        return sum(worst.values())

    def penalty(self, placement: Sequence[Tuple[int, int]],
                kind: Optional[str] = None) -> float:
        """Multiplicative score penalty ``1 + w·Lambda(P)·loss_s``."""
        w = self.model.risk_weight(kind)
        if w <= 0.0:
            return 1.0
        return 1.0 + w * self.gang_rate(placement) \
            * self.model.risk_loss_s()

    def penalty_batch(self, placements: Sequence[Sequence[Tuple[int,
                                                                int]]],
                      kind: Optional[str] = None) -> np.ndarray:
        """``penalty`` over a candidate batch (candidate sets are tiny,
        so the per-candidate group reduction stays a Python loop)."""
        w = self.model.risk_weight(kind)
        if w <= 0.0:
            return np.ones(len(placements))
        loss = self.model.risk_loss_s()
        return np.array([1.0 + w * self.gang_rate(p) * loss
                         for p in placements])


class ClusterView:
    """Read-only free-chip snapshot handed to policies (keeps them pure).

    ``capacities`` carries per-host chip counts (ragged last host) and
    ``speeds`` per-host speed factors; ``speeds is None`` means a
    homogeneous fleet and keeps every policy on its exact pre-CostModel
    integer code path.

    ``hetero`` / ``idle`` / ``idle_eff`` are optional precomputed
    summaries: the engine maintains them incrementally (commit/release
    deltas) and passes them in, so the per-decision loop no longer
    recomputes an O(hosts) reduction per property access.  When absent
    they are computed lazily, once, on first access."""

    __slots__ = ("free", "chips_per_host", "capacities", "speeds",
                 "_hetero", "_idle", "_idle_eff", "risk")

    def __init__(self, free: np.ndarray, chips_per_host: int,
                 capacities: Optional[np.ndarray] = None,
                 speeds: Optional[np.ndarray] = None,
                 hetero: Optional[bool] = None,
                 idle: Optional[int] = None,
                 idle_eff: Optional[float] = None,
                 risk: Optional[RiskContext] = None):
        self.free = free
        self.chips_per_host = chips_per_host
        # per-host risk metadata (None unless the engine's cost model
        # opted into the risk term — the risk-blind path never sees it)
        self.risk = risk
        self.capacities = (np.full(len(free), chips_per_host,
                                   dtype=np.int64)
                           if capacities is None
                           else np.asarray(capacities, dtype=np.int64))
        self.speeds = (None if speeds is None
                       else np.asarray(speeds, dtype=np.float64))
        self._hetero = hetero
        self._idle = idle
        self._idle_eff = idle_eff

    @property
    def hosts(self) -> int:
        return len(self.free)

    @property
    def heterogeneous(self) -> bool:
        """True when per-host speeds actually differ — a uniform-speed
        fleet (even at s != 1) ranks placements exactly like the
        homogeneous case, so policies keep the degenerate path.
        Cached (the answer cannot change for a given view)."""
        if self._hetero is None:
            self._hetero = self.speeds is not None and bool(
                (self.speeds != self.speeds[0]).any())
        return self._hetero

    def idle_chips(self) -> int:
        if self._idle is None:
            self._idle = int(self.free.sum())
        return self._idle

    def idle_throughput(self) -> float:
        """Idle capacity in effective (speed-weighted) chips; cached."""
        if self._idle_eff is None:
            self._idle_eff = (float(self.idle_chips())
                              if self.speeds is None
                              else float((self.free * self.speeds).sum()))
        return self._idle_eff


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------
class PlacementPolicy:
    """A pure placement function; the engine commits the result.

    ``kind`` is the job kind from the trace (``Job.kind``) so policies
    that consult the cost model use the same per-job beta as the
    simulator's rate integration; None falls back to the model default.
    """

    name = "abstract"
    slice_size = 0                          # granular unless overridden

    def place(self, view: ClusterView, n: int,
              kind: Optional[str] = None) -> Optional[Placement]:
        raise NotImplementedError

    def with_model(self, model: CostModel) -> "PlacementPolicy":
        """Bind an engine's cost model.  Policies that score with one
        return a bound copy (never mutating the shared ``POLICIES``
        singletons); stateless policies return self.  The engine calls
        this on every resolved policy so placement and execution always
        score with the *same* model — the one-model invariant."""
        return self


def _host_order(free: np.ndarray,
                speeds: Optional[np.ndarray] = None) -> np.ndarray:
    """Hosts by descending free capacity; on heterogeneous fleets by
    descending effective free throughput ``free_h·s_h``, tie-broken
    toward faster hosts (so equal-throughput fast hosts are preferred
    over one big slow host)."""
    if speeds is None:
        return np.argsort(free)[::-1]
    return np.lexsort((speeds, free * speeds))[::-1]


def _greedy_most_free_loop(free: np.ndarray, n: int,
                           speeds: Optional[np.ndarray] = None
                           ) -> Optional[Placement]:
    """Pre-vectorization reference: per-host Python loop over the greedy
    order (kept for ``reference_loops()`` A/B parity + benchmarking)."""
    order = _host_order(free, speeds)
    placement: Placement = []
    remaining = n
    for h in order:
        if free[h] == 0:
            continue
        take = min(int(free[h]), remaining)
        placement.append((int(h), take))
        remaining -= take
        if remaining == 0:
            break
    return sorted(placement) if remaining == 0 else None


def _greedy_most_free(free: np.ndarray, n: int,
                      speeds: Optional[np.ndarray] = None
                      ) -> Optional[Placement]:
    """Most-free-first greedy: the gang spans as few hosts as possible
    (as few *effective-throughput-ordered* hosts on mixed fleets).

    Vectorized cumulative-sum fill: hosts in greedy order contribute
    their full free count until the running total covers ``n``; the
    cutoff host contributes the remainder.  Zero-free hosts sort last in
    every greedy order (free and free·s are both 0), so the prefix never
    contains one — bit-identical to the reference loop."""
    if not _VECTORIZED:
        return _greedy_most_free_loop(free, n, speeds)
    order = _host_order(free, speeds)
    if free[order[0]] >= n:                  # whole gang on the top host
        return [(int(order[0]), n)]
    f = free[order]
    cum = np.cumsum(f)
    if cum.size == 0 or cum[-1] < n:
        return None
    k = int(np.searchsorted(cum, n))
    take = f[:k + 1]
    last = n - (int(cum[k - 1]) if k else 0)
    placement = [(int(h), int(c))
                 for h, c in zip(order[:k], take[:k])]
    placement.append((int(order[k]), last))
    return sorted(placement)


class BinpackPolicy(PlacementPolicy):
    """Faabric's default: fewest hosts via greedy most-free-first.  On a
    heterogeneous fleet the greedy order is the cost model's effective
    throughput ``free_h·s_h`` — the homogeneous case degenerates to the
    original free-chip order bit-exactly."""

    name = "binpack"

    def place(self, view: ClusterView, n: int,
              kind: Optional[str] = None) -> Optional[Placement]:
        if n > view.idle_chips():
            return None
        if view.risk is not None:
            # risk-discounted greedy order: short-lease / flaky hosts
            # sort as if slower, so the gang packs onto safe capacity
            # first (risk-indifferent kinds get None back and keep the
            # exact risk-blind order)
            rw = view.risk.order_speeds(kind, view.speeds)
            if rw is not None:
                return _greedy_most_free(view.free, n, rw)
        speeds = view.speeds if view.heterogeneous else None
        return _greedy_most_free(view.free, n, speeds)


def _spread_fill_loop(free: np.ndarray, n: int,
                      speeds: Optional[np.ndarray] = None
                      ) -> Optional[Placement]:
    """Pre-vectorization reference: one argmax per chip (kept for
    ``reference_loops()`` A/B parity + benchmarking, and still the
    implementation for heterogeneous fleets, where each chip shifts the
    effective-throughput weights by that host's speed)."""
    counts: Dict[int, int] = {}
    avail = free.copy()
    remaining = n
    while remaining > 0:
        candidates = np.nonzero(avail > 0)[0]
        if candidates.size == 0:
            return None
        weight = (avail[candidates] * speeds[candidates]
                  if speeds is not None else avail[candidates])
        h = int(candidates[np.argmax(weight)])
        counts[h] = counts.get(h, 0) + 1
        avail[h] -= 1
        remaining -= 1
    return sorted(counts.items())


def _spread_fill(free: np.ndarray, n: int,
                 speeds: Optional[np.ndarray] = None
                 ) -> Optional[Placement]:
    """Round-robin water-filling: each chip goes to the host with the
    most free chips (lowest index on ties).

    Homogeneous vectorized form: instead of one argmax per chip, whole
    *levels* are drained at once — with ``k`` hosts at the max level
    ``m1`` and the next level at ``m2``, the per-chip reference
    distributes the next ``k*(m1-m2)`` chips as full cycles over those
    hosts in ascending index order, so ``divmod`` gives each host ``q``
    chips and the first ``r`` (by index) one extra.  Bit-identical to
    the reference loop; heterogeneous fleets keep the per-chip loop
    (each chip moves that host's weight by its own speed factor)."""
    if not _VECTORIZED or speeds is not None:
        return _spread_fill_loop(free, n, speeds)
    if int(free.sum()) < n:
        return None
    # closed-form water level: the per-chip process drains every host
    # above level L, where L is the lowest level whose surplus
    # S(L) = sum(max(free - L, 0)) still fits in n; the n - S(L)
    # leftover chips come off the hosts sitting at L (free >= L), one
    # each in ascending index order — exactly the reference's final
    # partial cycle.  Levels are bounded by chips_per_host, so the
    # S scan is a tiny (levels x hosts) broadcast.
    levels = np.arange(int(free.max()) + 1)
    surplus = np.clip(free[None, :] - levels[:, None], 0, None).sum(axis=1)
    lvl = int(np.argmax(surplus <= n))
    counts = np.clip(free - lvl, 0, None)
    extra = n - int(surplus[lvl])
    if extra:
        at = np.nonzero(free >= max(lvl, 1))[0]
        counts[at[:extra]] += 1
    return [(int(h), int(counts[h])) for h in np.nonzero(counts)[0]]


class SpreadPolicy(PlacementPolicy):
    """Round-robin chips over hosts (load balancing); on mixed fleets
    each chip lands on the host with the most effective free throughput."""

    name = "spread"

    def place(self, view: ClusterView, n: int,
              kind: Optional[str] = None) -> Optional[Placement]:
        if n > view.idle_chips():
            return None
        if view.risk is not None:
            rw = view.risk.order_speeds(kind, view.speeds)
            if rw is not None:
                return _spread_fill(view.free, n, rw)
        speeds = view.speeds if view.heterogeneous else None
        return _spread_fill(view.free, n, speeds)


class FixedSlicePolicy(PlacementPolicy):
    """Whole-slice allocation: ceil(n/slice) slices, each on one host.

    Emulates the paper's k-containers-per-VM baselines: a host holds
    ``chips_per_host // slice_size`` slices; slices are never shared
    between jobs, so a request is rounded up to whole slices (the
    fragmentation waste of Fig 10).
    """

    name = "fixed-slice"

    def __init__(self, slice_size: int):
        assert slice_size > 0
        self.slice_size = slice_size

    def place(self, view: ClusterView, n: int,
              kind: Optional[str] = None) -> Optional[Placement]:
        slice_size = self.slice_size
        n_slices = -(-n // slice_size)
        free = view.free
        speeds = view.speeds if view.heterogeneous else None
        if view.risk is not None:
            rw = view.risk.order_speeds(kind, view.speeds)
            if rw is not None:
                speeds = rw          # host *ordering* only
        if not _VECTORIZED:
            return self._place_loop(free, n_slices, speeds)
        # vectorized: whole slices per host in greedy order, cumulative
        # cut at n_slices (hosts too small for one slice contribute 0
        # and are dropped — exactly what the reference loop skips)
        order = _host_order(free, speeds)
        slices = free[order] // slice_size
        cum = np.cumsum(slices)
        if cum.size == 0 or cum[-1] < n_slices:
            return None
        k = int(np.searchsorted(cum, n_slices))
        take = slices[:k + 1].copy()
        take[k] = n_slices - (int(cum[k - 1]) if k else 0)
        return sorted((int(h), int(s) * slice_size)
                      for h, s in zip(order[:k + 1], take) if s > 0)

    def _place_loop(self, free: np.ndarray, n_slices: int,
                    speeds: Optional[np.ndarray]) -> Optional[Placement]:
        """Pre-vectorization reference (``reference_loops()``)."""
        slice_size = self.slice_size
        placement: Dict[int, int] = {}
        need = n_slices
        for h in _host_order(free, speeds):
            while free[h] - placement.get(int(h), 0) >= slice_size \
                    and need > 0:
                placement[int(h)] = placement.get(int(h), 0) + slice_size
                need -= 1
            if need == 0:
                break
        if need:
            return None
        return sorted(placement.items())


class LocalityScoredPolicy(PlacementPolicy):
    """Minimise the predicted job time ``T`` of the §6 cost model.

    Candidate placements are scored by the model's per-unit-work ``T``
    (``CostModel.score``): on a homogeneous fleet ``Σ n_h·s_h`` is the
    same for every candidate, so the score degenerates to the slowdown
    factor ``(1 + beta_kind·chi)`` — bit-identical to the pre-CostModel
    behaviour; on a mixed-generation fleet the score trades cross-host
    fragmentation against host speed *per job kind* (a network-bound
    job with beta 13 co-locates on a slow host, a compute-bound job
    with beta 0.4 splits across the fast generation).  Ties (e.g. every
    single-host placement of a given speed has chi = 0) break on chips
    *stranded* on touched hosts: best-fit keeps large free blocks
    intact, so later gangs fragment less — that second-order effect is
    what lowers the trace-wide mean chi versus binpack's worst-fit
    choice of the most-free host.
    """

    name = "locality"

    def __init__(self, beta: Optional[float] = None,
                 cost_model: Optional[CostModel] = None):
        # an explicitly-configured policy keeps its model through
        # with_model; only the default construction (the POLICIES
        # singleton, by-name resolution) is rebindable to an engine's
        self._custom = cost_model is not None or beta is not None
        # an explicit beta overrides every kind (the pre-CostModel
        # semantics: one scalar scored all placements), so the
        # calibration table is dropped, not merely re-defaulted
        self.cost_model = cost_model or (
            CostModel() if beta is None
            else CostModel(betas={}, default_beta=beta))

    @property
    def beta(self) -> float:
        return self.cost_model.default_beta

    def with_model(self, model: CostModel) -> "LocalityScoredPolicy":
        if self._custom or model is self.cost_model:
            return self
        bound = LocalityScoredPolicy(cost_model=model)
        bound._custom = False           # engine-bound, still rebindable
        return bound

    def _stranded(self, view: ClusterView, placement: Placement) -> int:
        return sum(int(view.free[h]) - c for h, c in placement)

    def _candidates(self, view: ClusterView, n: int,
                    kind: Optional[str] = None,
                    risk: Optional[RiskContext] = None) -> List[Placement]:
        free = view.free
        candidates: List[Placement] = []
        fits = np.nonzero(free >= n)[0]
        if fits.size:                        # best-fit single host
            h = int(fits[np.argmin(free[fits])])
            candidates.append([(h, n)])
        greedy = _greedy_most_free(free, n)
        if greedy is not None:
            candidates.append(greedy)
        if not fits.size:
            # when a single host fits, exact-fill's first probe returns
            # the same best-fit single-host placement — skip the dup
            exact = self._greedy_exact_fill(free, n)
            if exact is not None:
                candidates.append(exact)
        if view.heterogeneous:
            # speed-aware candidates: the fastest single host that fits,
            # and the effective-throughput greedy over the fast hosts
            if fits.size:
                hf = int(fits[np.argmax(view.speeds[fits])])
                candidates.append([(hf, n)])
            fast = _greedy_most_free(free, n, view.speeds)
            if fast is not None:
                candidates.append(fast)
        if self.cost_model.collective_pricing and not fits.size:
            # balanced (maximin) split over the fewest hosts: the
            # two-level schedule ships bytes/min_fast over the slow
            # link, so a {5,5,5} split is ~5x cheaper than greedy's
            # ragged {7,7,1} — only the collective-priced score can
            # rank it, so the candidate is gated to that mode and the
            # default candidate set stays decision-identical
            bal = self._balanced_split(free, n)
            if bal is not None and bal not in candidates:
                candidates.append(bal)
        if risk is not None:
            # risk-avoiding candidates: the safest single host that
            # fits, and the risk-discounted greedy fill — only the
            # penalised score can rank them, so they are gated to the
            # risk-aware mode and the default set stays
            # decision-identical
            if fits.size:
                rates = risk.rates()
                hs = int(fits[np.argmin(rates[fits])])
                cand = [(hs, n)]
                if cand not in candidates:
                    candidates.append(cand)
            rw = risk.order_speeds(kind, view.speeds)
            if rw is not None:
                safe = _greedy_most_free(free, n, rw)
                if safe is not None and safe not in candidates:
                    candidates.append(safe)
        return candidates

    @staticmethod
    def _balanced_split(free: np.ndarray, n: int) -> Optional[Placement]:
        """Even (maximin) split of ``n`` over the fewest freest hosts."""
        order = np.argsort(-free, kind="stable")
        csum = np.cumsum(free[order])
        if not csum.size or csum[-1] < n:
            return None
        k = int(np.searchsorted(csum, n)) + 1
        hosts = order[:k][::-1]          # ascending free: caps bind first
        placement: Placement = []
        rem = n
        for i, h in enumerate(hosts):
            share = min(int(free[h]), -(-rem // (k - i)))
            if share <= 0:
                return None
            placement.append((int(h), share))
            rem -= share
        return placement if rem == 0 else None

    def place(self, view: ClusterView, n: int,
              kind: Optional[str] = None) -> Optional[Placement]:
        if n > view.idle_chips():
            return None
        hetero = view.heterogeneous
        # risk term active for this kind?  (weight 0 keeps the exact
        # risk-blind decision path, including the short-circuit below)
        risk = view.risk
        if risk is not None and self.cost_model.risk_weight(kind) <= 0.0:
            risk = None
        if _VECTORIZED and not hetero and risk is None:
            # best-fit short-circuit: when some host fits the whole
            # gang, every candidate is single-host (chi = 0 for all, so
            # the score ties) and best-fit strands the fewest chips —
            # greedy's most-free host can never win the (score,
            # stranded) key, and exact-fill's first probe *is* the
            # best-fit host.  Decision-identical to scoring the full
            # candidate set, without the fills.  With the risk term
            # active single-host candidates no longer tie (hazards
            # differ), so risk-aware decisions must score the full set.
            fits = np.nonzero(view.free >= n)[0]
            if fits.size:
                return [(int(fits[np.argmin(view.free[fits])]), n)]
        candidates = self._candidates(view, n, kind=kind, risk=risk)
        if not candidates:
            return None
        if _VECTORIZED:
            # batched scoring: one numpy pass over all candidates'
            # (host, chips) pairs; per-candidate float operation order
            # matches the Python reduction (bincount accumulates in
            # flat order), and the stable lexsort keeps min()'s
            # first-of-equals tie-break on (score, stranded)
            if hetero:
                scores = self.cost_model.score_batch(candidates, kind,
                                                     view.speeds)
            elif self.cost_model.collective_pricing:
                # achievable-schedule pricing (DESIGN.md §11): rank by
                # the best collective time on each candidate topology
                scores = self.cost_model.score_batch(candidates, kind)
            else:
                # the exact pre-CostModel homogeneous key 1 + beta*chi
                scores = 1.0 + self.cost_model.beta(kind) \
                    * _chi_batch(candidates)
            if risk is not None:
                # expected-lost-work penalty (DESIGN.md §13): steers
                # the argmin, never the charged rate
                scores = scores * risk.penalty_batch(candidates, kind)
            k = len(candidates)
            sizes = np.array([len(p) for p in candidates])
            seg = np.repeat(np.arange(k), sizes)
            hosts = np.array([h for p in candidates for h, _ in p],
                             dtype=np.int64)
            chips = np.array([c for p in candidates for _, c in p],
                             dtype=np.int64)
            stranded = np.bincount(
                seg, weights=(view.free[hosts] - chips).astype(
                    np.float64), minlength=k)
            return candidates[int(np.lexsort((stranded, scores))[0])]
        if hetero or self.cost_model.collective_pricing:
            # reference Python reduction
            model = self.cost_model
            speeds = view.speeds if hetero else None
            return min(candidates, key=lambda p: (
                model.score(p, kind, speeds)
                * (risk.penalty(p, kind) if risk is not None else 1.0),
                self._stranded(view, p)))
        # homogeneous: Σ n_h·s_h is constant, so T reduces to the
        # slowdown — the exact pre-CostModel scoring key
        beta = self.cost_model.beta(kind)
        return min(candidates, key=lambda p: (
            (1.0 + beta * placement_cross_host_fraction(p))
            * (risk.penalty(p, kind) if risk is not None else 1.0),
            self._stranded(view, p)))

    @staticmethod
    def _greedy_exact_fill_loop(free: np.ndarray,
                                n: int) -> Optional[Placement]:
        """Pre-vectorization reference (``reference_loops()``): one
        full-array scan per host drained."""
        avail = free.copy()
        placement: Placement = []
        remaining = n
        while remaining > 0:
            fits = np.nonzero(avail >= remaining)[0]
            if fits.size:
                h = int(fits[np.argmin(avail[fits])])
                placement.append((h, remaining))
                remaining = 0
                break
            h = int(np.argmax(avail))
            if avail[h] == 0:
                return None
            take = int(avail[h])
            placement.append((h, take))
            avail[h] = 0
            remaining -= take
        return sorted(placement)

    @staticmethod
    def _greedy_exact_fill(free: np.ndarray, n: int) -> Optional[Placement]:
        """Greedy most-free-first, but finish the remainder on the
        best-fit host (smallest free count that still covers it) — same
        chi as plain greedy when the chunk multiset matches, strictly
        fewer stranded chips otherwise.

        Vectorized: the reference drains hosts in stable most-free
        order (repeated argmax = descending free, ascending index on
        ties) until some host covers the remainder, so the cut point is
        the first prefix position whose host already fits what is left
        — one cumulative-sum comparison instead of a scan per host."""
        if not _VECTORIZED:
            return LocalityScoredPolicy._greedy_exact_fill_loop(free, n)
        order = np.argsort(-free, kind="stable")
        f = free[order]
        cum = np.cumsum(f)
        rem = n - (cum - f)                  # remainder before each step
        cond = f >= rem
        if not cond.any():
            return None                      # total free < n
        k = int(np.argmax(cond))
        rem_k = int(rem[k])
        # best-fit finisher: f[k:] is descending, so the untaken hosts
        # that still fit rem_k form a prefix; the smallest fitting value
        # m sits at the prefix end, and (stable sort = ascending index
        # within a value run) the lowest-index host with value m is the
        # run's first position at or past k
        cut = int(np.searchsorted(-f[k:], -rem_k, side="right"))
        m = int(f[k + cut - 1])
        start = int(np.searchsorted(-f, -m, side="left"))
        finisher = int(order[max(k, start)])
        placement = [(int(order[i]), int(f[i])) for i in range(k)]
        placement.append((finisher, rem_k))
        return sorted(placement)


POLICIES: Dict[str, PlacementPolicy] = {
    "binpack": BinpackPolicy(),
    "spread": SpreadPolicy(),
    "locality": LocalityScoredPolicy(),
}


def resolve_policy(policy: Union[str, PlacementPolicy, None],
                   default: Optional[PlacementPolicy] = None
                   ) -> PlacementPolicy:
    if policy is None:
        assert default is not None
        return default
    if isinstance(policy, PlacementPolicy):
        return policy
    try:
        return POLICIES[policy]
    except KeyError:
        raise ValueError(f"unknown placement policy: {policy!r}") from None


# ---------------------------------------------------------------------------
# Preemption
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PreemptPolicy:
    """Victim selection for a high-priority arrival that cannot be placed.

    Victims are strictly-lower-priority gangs, evicted cheapest-first:
    lowest priority class first, and within a class the largest gang first
    (frees the most chips per eviction).  Greedy selection stops as soon
    as the arrival fits under the engine's placement policy; a prune pass
    then drops any victim the fit does not actually need — preferring to
    spare the *higher*-priority ones — so no gang is evicted needlessly.
    The plan is a pure decision — the caller performs the actual
    checkpoint + release + requeue.

    The fit probe runs the placement policy against the engine's real
    view (capacities, per-host speeds, the arrival's job kind), so a
    preemption planned in simulation lands identically on the live
    fabric.

    ``max_victims`` bounds the blast radius of one arrival (0 = unbounded).
    """

    max_victims: int = 0

    def plan(self, engine: "PlacementEngine", n: int, priority: int,
             priorities: Dict[str, int],
             policy: Union[str, PlacementPolicy, None] = None,
             kind: Optional[str] = None) -> Optional[List[str]]:
        """job_ids to evict so an ``n``-chip gang at ``priority`` places;
        ``None`` if no lower-priority victim set suffices, ``[]`` if it
        already fits without eviction."""
        pol = resolve_policy(policy, engine.default_policy).with_model(
            engine.cost_model)
        scratch = engine.free.copy()
        # victims' chips on a draining host are being reclaimed by the
        # provider — they never count toward the fit probe (churn-free
        # fleets skip the mask entirely: bit-identical pre-churn path)
        drain = getattr(engine, "draining", None)
        if drain is not None and not drain.any():
            drain = None

        def fits() -> bool:
            probe = scratch if drain is None else np.where(drain, 0,
                                                           scratch)
            return pol.place(engine.view_with(probe), n,
                             kind=kind) is not None

        if fits():
            return []
        # cheapest-first victim order: priority asc, gang size desc, id
        victims = sorted(
            (a for a in engine.allocations.values()
             if priorities.get(a.job_id, 0) < priority),
            key=lambda a: (priorities.get(a.job_id, 0), -a.n, a.job_id))
        chosen: List[Allocation] = []
        for a in victims:
            for h, c in a.placement:
                scratch[h] += c
            chosen.append(a)
            if fits():
                break
        else:
            return None
        # prune needless victims, sparing higher-priority gangs first
        for a in sorted(chosen,
                        key=lambda a: (-priorities.get(a.job_id, 0), a.n,
                                       a.job_id)):
            for h, c in a.placement:
                scratch[h] -= c
            if fits():
                chosen.remove(a)        # not needed after all
            else:
                for h, c in a.placement:
                    scratch[h] += c
        if self.max_victims and len(chosen) > self.max_victims:
            return None
        return [a.job_id for a in chosen]


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Reservation:
    """Chips held but not yet bound to a job.

    The preemption-safe handshake: ``reserve`` carves the chips out of the
    free pool atomically, so a multi-step decision (e.g. elastic grow:
    decide, snapshot, reshard) cannot lose the chips to a concurrent
    allocation; ``commit`` binds them to a job, ``cancel`` returns them.
    """

    placement: Placement
    slice_size: int = 0
    settled: bool = False                   # committed or cancelled

    @property
    def n(self) -> int:
        return sum(c for _, c in self.placement)


class PlacementEngine:
    """Free-chip accounting + policy-driven gang allocation for a cluster
    of ``hosts`` hosts with ``chips_per_host`` chips each.  ``capacities``
    overrides per-host chip counts (e.g. a ragged last host); ``speeds``
    carries per-host speed factors for mixed host generations;
    ``cost_model`` is the shared job-time model policies and plans score
    against."""

    def __init__(self, hosts: int, chips_per_host: int,
                 policy: Union[str, PlacementPolicy] = "binpack",
                 capacities: Optional[Sequence[int]] = None,
                 speeds: Optional[Sequence[float]] = None,
                 cost_model: Optional[CostModel] = None):
        self.hosts = hosts
        self.chips_per_host = chips_per_host
        if capacities is None:
            self.capacities = np.full(hosts, chips_per_host, dtype=np.int64)
        else:
            assert len(capacities) == hosts
            self.capacities = np.asarray(capacities, dtype=np.int64)
            assert (self.capacities >= 0).all() \
                and (self.capacities <= chips_per_host).all()
        if speeds is None:
            self.speeds: Optional[np.ndarray] = None
        else:
            assert len(speeds) == hosts
            self.speeds = np.asarray(speeds, dtype=np.float64)
            assert (self.speeds > 0).all()
        self.cost_model = cost_model if cost_model is not None \
            else CostModel()
        self.free = self.capacities.copy()
        self.jobs_on_host: List[set] = [set() for _ in range(hosts)]
        self.default_policy = resolve_policy(policy).with_model(
            self.cost_model)
        self.allocations: Dict[str, Allocation] = {}
        # resolved-and-model-bound policies, cached per engine: the old
        # path re-ran resolve_policy(...).with_model(...) on every
        # decision, constructing a fresh bound LocalityScoredPolicy each
        # time the by-name singleton met a non-default model
        self._policy_cache: Dict[Union[str, int],
                                 Tuple[object, PlacementPolicy]] = {}
        # incrementally-maintained free-chip summaries (commit/release
        # deltas through _take/_give) — the per-decision loop never
        # recomputes an O(hosts) reduction for these
        self._hetero = self.speeds is not None and bool(
            (self.speeds != self.speeds[0]).any())
        self._idle_chips = int(self.free.sum())
        self._idle_eff = (float(self._idle_chips) if self.speeds is None
                          else float((self.free * self.speeds).sum()))
        # forwarding hops of the last placement decision (always 0 for
        # the centralised engine; ShardedPlacementEngine counts the
        # shards a decision consulted beyond its home shard)
        self.decision_hops = 0
        # fleet churn (core.fleet): hosts being lease-reclaimed take no
        # new placements and retire chips as gangs leave; _any_draining
        # keeps every churn-free hot path on its exact pre-churn code
        self.draining = np.zeros(hosts, dtype=bool)
        self._any_draining = False
        # per-host risk metadata (DESIGN.md §13): absolute lease-expiry
        # times (inf = reserved / no known end), online hazard estimates
        # (events/s, fed from observed FleetEvent history), and
        # blast-radius group ids (default: every host its own group).
        # Benign defaults; inert until the cost model opts into the risk
        # term, so risk-blind decisions are bit-identical.
        self.lease_until_s = np.full(hosts, np.inf)
        self.hazards = np.zeros(hosts)
        self.blast_group = np.arange(hosts, dtype=np.int64)
        self.risk_now = 0.0
        self._risk_cache: Optional[RiskContext] = None

    @classmethod
    def for_chips(cls, n_chips: int, chips_per_host: int,
                  **kwargs) -> "PlacementEngine":
        """Engine for a flat pool of ``n_chips`` devices — host count and
        the ragged last host come from ``derive_capacities`` (the single
        shared derivation; ``core.fabric.Fabric`` builds through here)."""
        caps = derive_capacities(n_chips, chips_per_host)
        return cls(len(caps), chips_per_host, capacities=caps, **kwargs)

    # ---- capacity ----------------------------------------------------------
    @property
    def total_chips(self) -> int:
        return int(self.capacities.sum())

    @property
    def heterogeneous(self) -> bool:
        return self._hetero

    @property
    def sched_hosts(self) -> int:
        """Hosts one scheduling decision scans — the centralised
        engine's Fig 11 latency term (the sharded engine overrides this
        with its per-shard host count)."""
        return self.hosts

    def idle_chips(self) -> int:
        return self._idle_chips

    def idle_fraction(self) -> float:
        total = self.total_chips        # shrinks under fleet churn
        return self._idle_chips / total if total else 0.0

    def idle_throughput(self) -> float:
        """Idle capacity in effective (speed-weighted) chips —
        incrementally maintained, not recomputed per call."""
        return self._idle_eff

    def view(self) -> ClusterView:
        """Policy view over the live free map.  No copy: views are
        read-only by the policy contract (policies copy before they
        mutate), and the engine only moves chips after ``place``
        returns — so the hot path skips an O(hosts) copy per decision."""
        return ClusterView(self.free, self.chips_per_host,
                           self.capacities, self.speeds,
                           hetero=self._hetero, idle=self._idle_chips,
                           idle_eff=self._idle_eff,
                           risk=self._risk_context())

    def view_with(self, free: np.ndarray) -> ClusterView:
        """A policy view over an alternative free map (scratch planning)
        that still carries this engine's capacities and speeds."""
        return ClusterView(free, self.chips_per_host,
                           self.capacities, self.speeds,
                           hetero=self._hetero,
                           risk=self._risk_context())

    # ---- risk metadata (leases / failure history; DESIGN.md §13) ----------
    def _risk_context(self) -> Optional[RiskContext]:
        """The RiskContext views carry — None unless the cost model
        opted into the risk term, cached until the metadata or the
        clock moves (rates are free-map-independent)."""
        if not self.cost_model.risk_aware:
            return None
        ctx = self._risk_cache
        if ctx is None or ctx.now != self.risk_now:
            ctx = RiskContext(self.cost_model, self.lease_until_s,
                              self.hazards, self.blast_group,
                              self.risk_now)
            self._risk_cache = ctx
        return ctx

    def set_host_risk(self,
                      lease_until_s: Optional[Sequence[float]] = None,
                      hazards: Optional[Sequence[float]] = None,
                      blast_groups: Optional[Sequence[int]] = None
                      ) -> None:
        """Bulk-install risk metadata (lease table from the provider,
        hazard estimates from ``fleet.HazardEstimator``, blast groups
        from rack topology).  Lengths must match the current fleet."""
        if lease_until_s is not None:
            arr = np.asarray(lease_until_s, dtype=np.float64)
            assert len(arr) == self.hosts
            self.lease_until_s = arr
        if hazards is not None:
            arr = np.asarray(hazards, dtype=np.float64)
            assert len(arr) == self.hosts
            self.hazards = arr
        if blast_groups is not None:
            arr = np.asarray(blast_groups, dtype=np.int64)
            assert len(arr) == self.hosts
            self.blast_group = arr
        self._risk_cache = None

    def risk_tick(self, now: float) -> None:
        """Advance the clock lease-remaining is measured against (the
        scheduling loop calls this before placing under risk)."""
        self.risk_now = float(now)

    def _copy_risk_to(self, eng: "PlacementEngine") -> None:
        eng.lease_until_s = self.lease_until_s.copy()
        eng.hazards = self.hazards.copy()
        eng.blast_group = self.blast_group.copy()
        eng.risk_now = self.risk_now

    def clone_empty(self) -> "PlacementEngine":
        """A fresh, idle engine of the same shape (hosts, capacities,
        speeds, policy, cost model) — what ``Fabric.predict_trace``
        simulates against so prediction and live execution share one
        accounting configuration."""
        eng = type(self)(self.hosts, self.chips_per_host,
                         policy=self.default_policy,
                         capacities=list(self.capacities),
                         speeds=None if self.speeds is None
                         else list(self.speeds),
                         cost_model=self.cost_model)
        self._copy_risk_to(eng)        # prediction sees the same leases
        return eng

    # ---- free-map mutation (the one place chips move) ----------------------
    def _take(self, placement: Sequence[Tuple[int, int]]) -> None:
        """Move chips out of the free pool, maintaining the incremental
        summaries.  Every mutation path (reserve/bind/apply_migration)
        funnels through here so subclasses can track shard summaries.
        Conservation is asserted per touched host — O(gang), replacing
        the old O(hosts) full-map scans on the per-decision path.  Wide
        placements (a spread gang touches ~n hosts) take the fancy-index
        path; short ones stay on the cheaper scalar loop.  Fancy
        indexing applies ONE update per index, so a placement that
        repeats a host (never policy-emitted, but ``bind`` adopts
        external placements) must take the scalar loop instead."""
        if len(placement) > 4 \
                and len({h for h, _ in placement}) == len(placement):
            hs = np.array([h for h, _ in placement], dtype=np.int64)
            cs = np.array([c for _, c in placement], dtype=np.int64)
            self.free[hs] -= cs
            assert (self.free[hs] >= 0).all(), "host oversubscribed"
            self._idle_chips -= int(cs.sum())
            if self.speeds is not None:
                self._idle_eff -= float((cs * self.speeds[hs]).sum())
            else:
                self._idle_eff = float(self._idle_chips)
            return
        taken = 0
        for h, c in placement:
            self.free[h] -= c
            assert self.free[h] >= 0, f"host {h} oversubscribed"
            taken += c
            if self.speeds is not None:
                self._idle_eff -= c * float(self.speeds[h])
        self._idle_chips -= taken
        if self.speeds is None:
            self._idle_eff = float(self._idle_chips)

    def _retire_draining(self, placement: Sequence[Tuple[int, int]]
                         ) -> Sequence[Tuple[int, int]]:
        """Chips returned on a draining host go back to the *provider*,
        not the free pool: the host's capacity shrinks to its remaining
        usage (when it hits 0 the lease is fully surrendered).  Returns
        the entries that still free normally.  Only called when some
        host is draining, so churn-free paths never pay for it."""
        live: List[Tuple[int, int]] = []
        for h, c in placement:
            if self.draining[h]:
                self.capacities[h] -= c
                assert self.capacities[h] >= 0, f"host {h} over-retired"
            else:
                live.append((h, c))
        return live

    def _give(self, placement: Sequence[Tuple[int, int]]) -> None:
        """Return chips to the free pool (inverse of ``_take``; same
        unique-host requirement for the fancy-index path).  Chips landing
        on a draining host are retired instead (``_retire_draining``)."""
        if self._any_draining:
            placement = self._retire_draining(placement)
            if not placement:
                return
        if len(placement) > 4 \
                and len({h for h, _ in placement}) == len(placement):
            hs = np.array([h for h, _ in placement], dtype=np.int64)
            cs = np.array([c for _, c in placement], dtype=np.int64)
            self.free[hs] += cs
            assert (self.free[hs] <= self.capacities[hs]).all(), \
                "host over-freed"
            self._idle_chips += int(cs.sum())
            if self.speeds is not None:
                self._idle_eff += float((cs * self.speeds[hs]).sum())
            else:
                self._idle_eff = float(self._idle_chips)
            return
        given = 0
        for h, c in placement:
            self.free[h] += c
            assert self.free[h] <= self.capacities[h], \
                f"host {h} over-freed"
            given += c
            if self.speeds is not None:
                self._idle_eff += c * float(self.speeds[h])
        self._idle_chips += given
        if self.speeds is None:
            self._idle_eff = float(self._idle_chips)

    def _resolve(self, policy: Union[str, PlacementPolicy, None]
                 ) -> PlacementPolicy:
        """Resolved policy bound to this engine's cost model, cached
        (one ``with_model`` bind per distinct policy per engine instead
        of one per decision)."""
        if policy is None:
            return self.default_policy
        key = policy if isinstance(policy, str) else id(policy)
        hit = self._policy_cache.get(key)
        if hit is not None and (hit[0] is policy or hit[0] == policy):
            return hit[1]
        pol = resolve_policy(policy, self.default_policy).with_model(
            self.cost_model)
        self._policy_cache[key] = (policy, pol)
        return pol

    # ---- telemetry ----------------------------------------------------------
    def _record_decision(self, name: str, t0: float, *,
                         n: Optional[int] = None,
                         placed: Optional[bool] = None,
                         policy: Union[str, PlacementPolicy, None] = None,
                         kind: Optional[str] = None,
                         plans: Optional[int] = None) -> None:
        """Record one scheduling decision's span + latency histogram.
        Only called from the public decision wrappers, and only when a
        live telemetry recorder is installed."""
        tel = telemetry.get()
        t1 = time.perf_counter()
        dt = t1 - t0
        tel.count(f"placement.{name}")
        tel.observe("placement.decision_latency_s", dt)
        tel.observe(f"placement.{name}_latency_s", dt)
        pol = policy if isinstance(policy, str) else (
            "default" if policy is None else type(policy).__name__)
        steal = getattr(self, "_steal_left", None)
        budget = getattr(self, "steal_budget", 0)
        attrs = {"policy": pol, "kind": kind,
                 "engine": type(self).__name__,
                 "hops": int(self.decision_hops),
                 "candidates": int((self.free > 0).sum())}
        if n is not None:
            attrs["n"] = int(n)
        if placed is not None:
            attrs["placed"] = bool(placed)
        if plans is not None:
            attrs["plans"] = int(plans)
        if budget and steal is not None and steal != float("inf"):
            attrs["steal_spent"] = int(budget - steal)
        tel.span_at(f"placement.{name}", t0, t1, track="sched",
                    clock="wall", **attrs)

    # ---- reservation lifecycle ---------------------------------------------
    def reserve(self, n: int,
                policy: Union[str, PlacementPolicy, None] = None,
                kind: Optional[str] = None) -> Optional[Reservation]:
        if not telemetry.get().enabled:
            return self._reserve_impl(n, policy, kind=kind)
        t0 = time.perf_counter()
        res = self._reserve_impl(n, policy, kind=kind)
        self._record_decision("reserve", t0, n=n, placed=res is not None,
                              policy=policy, kind=kind)
        return res

    def _reserve_impl(self, n: int,
                      policy: Union[str, PlacementPolicy, None] = None,
                      kind: Optional[str] = None) -> Optional[Reservation]:
        if _VECTORIZED:
            if n > self._idle_chips:
                # no policy can place n chips with fewer idle (every
                # placement draws at least n from the free pool), so a
                # blocked-queue probe fails before building a view
                return None
            pol = self._resolve(policy)
            view = self.view()
        else:
            # pre-PR decision path (reference_loops): re-resolve + bind
            # the policy, copy the view, recompute summaries per access
            pol = resolve_policy(policy, self.default_policy).with_model(
                self.cost_model)
            view = ClusterView(self.free.copy(), self.chips_per_host,
                               self.capacities, self.speeds)
        placement = pol.place(view, n, kind=kind)
        if placement is None:
            return None
        self._take(placement)
        if not _VECTORIZED:
            assert (self.free >= 0).all()
        return Reservation(placement, slice_size=pol.slice_size)

    def commit(self, res: Reservation, job_id: str) -> Allocation:
        assert not res.settled, "reservation already settled"
        res.settled = True
        for h, _ in res.placement:
            self.jobs_on_host[h].add(job_id)
        alloc = Allocation(job_id, sorted(res.placement),
                           slice_size=res.slice_size)
        self.allocations[job_id] = alloc
        return alloc

    def cancel(self, res: Reservation) -> None:
        assert not res.settled, "reservation already settled"
        res.settled = True
        self._give(res.placement)       # per-host conservation asserts

    # ---- allocation ----------------------------------------------------------
    def allocate(self, job_id: str, n: int,
                 policy: Union[str, PlacementPolicy, None] = None,
                 kind: Optional[str] = None) -> Optional[Allocation]:
        res = self.reserve(n, policy, kind=kind)
        return None if res is None else self.commit(res, job_id)

    def bind(self, job_id: str, placement: Sequence[Tuple[int, int]],
             slice_size: int = 0) -> Allocation:
        """Adopt an externally-determined placement (the live runtime
        attaching the gang it was launched with)."""
        for h, c in placement:
            assert 0 < c <= self.free[h], \
                f"bind over-subscribes host {h}: {c} > {self.free[h]}"
            self.jobs_on_host[h].add(job_id)
        self._take(placement)
        alloc = Allocation(job_id, sorted(placement), slice_size=slice_size)
        self.allocations[job_id] = alloc
        return alloc

    def release(self, alloc: Allocation) -> None:
        for h, _ in alloc.placement:
            self.jobs_on_host[h].discard(alloc.job_id)
        self._give(alloc.placement)     # per-host conservation asserts
        self.allocations.pop(alloc.job_id, None)

    # ---- preemption -----------------------------------------------------------
    def preemption_plan(self, n: int, priority: int,
                        priorities: Dict[str, int],
                        policy: Union[str, PlacementPolicy, None] = None,
                        preempt: Optional[PreemptPolicy] = None,
                        kind: Optional[str] = None) -> Optional[List[str]]:
        if not telemetry.get().enabled:
            return self._preemption_impl(n, priority, priorities,
                                         policy=policy, preempt=preempt,
                                         kind=kind)
        t0 = time.perf_counter()
        plan = self._preemption_impl(n, priority, priorities,
                                     policy=policy, preempt=preempt,
                                     kind=kind)
        self._record_decision("preemption_plan", t0, n=n,
                              placed=plan is not None, policy=policy,
                              kind=kind,
                              plans=len(plan) if plan else 0)
        return plan

    def _preemption_impl(self, n: int, priority: int,
                         priorities: Dict[str, int],
                         policy: Union[str, PlacementPolicy, None] = None,
                         preempt: Optional[PreemptPolicy] = None,
                         kind: Optional[str] = None
                         ) -> Optional[List[str]]:
        """Plan victims (see ``PreemptPolicy.plan``) against the live
        allocation table; the caller checkpoints + releases + requeues."""
        return (preempt or PreemptPolicy()).plan(self, n, priority,
                                                 priorities, policy,
                                                 kind=kind)

    # ---- migration (defragmentation at barrier points) ------------------------
    def migration_plan(self, allocs: Sequence[Allocation],
                       kinds: Optional[Mapping[str, str]] = None,
                       remaining: Optional[Mapping[str, float]] = None
                       ) -> List[Tuple[str, Placement]]:
        if not telemetry.get().enabled:
            return self._migration_impl(allocs, kinds=kinds,
                                        remaining=remaining)
        t0 = time.perf_counter()
        plans = self._migration_impl(allocs, kinds=kinds,
                                     remaining=remaining)
        self._record_decision("migration_plan", t0, n=len(allocs),
                              plans=len(plans))
        return plans

    def _migration_impl(self, allocs: Sequence[Allocation],
                       kinds: Optional[Mapping[str, str]] = None,
                       remaining: Optional[Mapping[str, float]] = None
                       ) -> List[Tuple[str, Placement]]:
        """For each granular gang, try to find a better placement using
        currently-free chips (+ the chips the gang already holds).
        Returns [(job_id, new_placement)].

        Homogeneous fleet: consolidate fragmented gangs onto fewer hosts
        (the pre-CostModel behaviour, bit-identical).  Heterogeneous
        fleet: candidate moves are costed with the engine's ``CostModel``
        under the gang's job kind (``kinds``), so a gang also migrates
        onto faster hosts when that lowers its predicted ``T`` — the
        same criterion the simulator's rate integration uses.
        ``remaining`` (job_id -> seconds of work left under the current
        placement) makes that check cost-aware: the predicted saving on
        the remaining work must exceed ``CostModel.migration_cost_s``
        (the snapshot transfer the move will pay).  Without it (a
        caller-initiated live barrier migration) any strict improvement
        is emitted.

        Invariants: slice allocations are never migrated; a plan that
        does not strictly improve (fewer hosts / lower predicted T) is
        not emitted; plans are committed against a scratch free map so
        they never double-book chips among themselves.
        """
        plans = []
        free = self.free.copy()
        drain = self.draining if self._any_draining else None
        for alloc in allocs:
            new_placement = self._plan_move(
                free, alloc, alloc.placement, self.heterogeneous,
                self.speeds, (kinds or {}).get(alloc.job_id),
                (remaining or {}).get(alloc.job_id), draining=drain)
            if new_placement is not None:
                plans.append((alloc.job_id, new_placement))
        return plans

    def _plan_move(self, free: np.ndarray, alloc: Allocation,
                   placement: Placement, hetero: bool,
                   speeds: Optional[np.ndarray], kind: Optional[str],
                   rem: Optional[float],
                   draining: Optional[np.ndarray] = None
                   ) -> Optional[Placement]:
        """Plan one gang's move against the scratch ``free`` map (shared
        across the whole planning pass so plans never double-book) and
        commit the winning plan into it.  ``free``/``placement``/
        ``speeds`` share a coordinate space — global for the centralised
        engine, a shard slice (with local host indices) for shard-local
        planning — so a shard decision only touches its own O(shard)
        state.  Returns the new placement, or None to stay put.

        Scratch mutation in place of the old per-gang ``free.copy()``:
        the gang's held chips are added before planning and removed
        again when no plan is emitted — O(gang) instead of O(hosts) per
        candidate gang (``reference_loops()`` restores the pre-PR
        per-gang copy for A/B benchmarking)."""
        if alloc.slice_size:
            return None
        if not hetero and len(placement) <= 1:
            return None
        model = self.cost_model
        avail = free if _VECTORIZED else free.copy()
        # gang's own chips count — except chips on a draining host,
        # which are being reclaimed and must not be re-planned onto
        # (a draining host's free is already 0, so nothing else can
        # land there either); churn-free fleets pass draining=None
        cred = placement if draining is None else [
            (h, c) for h, c in placement if not draining[h]]
        for h, c in cred:
            avail[h] += c
        new_placement: Optional[Placement] = None
        if hetero:
            current = model.score(placement, kind, speeds)
            candidates = [p for p in (
                _greedy_most_free(avail, alloc.n, speeds),
                _greedy_most_free(avail, alloc.n))
                if p is not None and p != placement]
            if candidates:
                best = min(candidates,
                           key=lambda p: model.score(p, kind, speeds))
                best_score = model.score(best, kind, speeds)
                if best_score < current - 1e-12:
                    # rate scales as 1/score, so the move shrinks the
                    # remaining time by rem*(1 - best/current); it must
                    # buy back the snapshot transfer it costs
                    if rem is None or rem * (1.0 - best_score / current) \
                            > model.migration_cost_s:
                        new_placement = best
        else:
            # can the gang fit on fewer hosts?
            cand = _greedy_most_free(avail, alloc.n)
            if cand is not None and len(cand) < len(placement):
                new_placement = cand
        if new_placement is None:             # stay put: undo the credit
            if avail is free:
                for h, c in cred:
                    free[h] -= c
            return None
        if avail is free:                     # commit into the scratch
            for h, c in new_placement:
                free[h] -= c
        else:
            for h, c in cred:
                free[h] += c
            for h, c in new_placement:
                free[h] -= c
        return new_placement

    def apply_migration(self, alloc: Allocation,
                        new_placement: Sequence[Tuple[int, int]]
                        ) -> Allocation:
        self.release(alloc)
        for h, _ in new_placement:
            self.jobs_on_host[h].add(alloc.job_id)
        self._take(new_placement)       # per-host conservation asserts
        new = Allocation(alloc.job_id, sorted(new_placement))
        self.allocations[alloc.job_id] = new
        return new

    # ---- fleet churn (leased hosts come and go; see core.fleet) -------------
    def alive_hosts(self) -> int:
        """Hosts still holding capacity (leased and not fully retired) —
        what adaptive shard sizing scales against."""
        return int((self.capacities > 0).sum())

    # True when a scheduling loop (the simulator's queue pump) owns the
    # steal-budget lifecycle; False = direct use, where each decision
    # resets its own budget (a per-decision cap) so a one-shot caller
    # can never be starved by budget a past decision spent
    external_budget_reset = False

    def reset_steal_budget(self) -> None:
        """Per-scheduling-pass budget reset (a no-op here; the sharded
        engine caps cross-shard split/escalation attempts per pump)."""

    def add_hosts(self, capacities: Sequence[int],
                  speeds: Optional[Sequence[float]] = None) -> List[int]:
        """Lease new hosts into the fleet (a FleetEvent ``join``).

        New hosts append at the end of the index space (retired host
        slots are never reused, so existing placements keep their
        coordinates).  ``speeds`` carries the new hosts' generation
        factors; when either side of the fleet has speeds the other is
        padded at 1.0.  Returns the new host indices."""
        caps = np.asarray(list(capacities), dtype=np.int64)
        assert len(caps) > 0 and (caps > 0).all() \
            and (caps <= self.chips_per_host).all()
        k = len(caps)
        new_idx = list(range(self.hosts, self.hosts + k))
        if speeds is not None or self.speeds is not None:
            old = (self.speeds if self.speeds is not None
                   else np.ones(self.hosts, dtype=np.float64))
            new = (np.asarray(list(speeds), dtype=np.float64)
                   if speeds is not None
                   else np.ones(k, dtype=np.float64))
            assert len(new) == k and (new > 0).all()
            self.speeds = np.concatenate([old, new])
        self.capacities = np.concatenate([self.capacities, caps])
        self.free = np.concatenate([self.free, caps])
        self.draining = np.concatenate(
            [self.draining, np.zeros(k, dtype=bool)])
        # risk metadata grows with benign defaults: fresh leases with
        # no known end, no failure history, each joiner its own blast
        # group (callers refine via set_host_risk)
        self.lease_until_s = np.concatenate(
            [self.lease_until_s, np.full(k, np.inf)])
        self.hazards = np.concatenate([self.hazards, np.zeros(k)])
        nb = (int(self.blast_group.max()) + 1 if len(self.blast_group)
              else 0)
        self.blast_group = np.concatenate(
            [self.blast_group, np.arange(nb, nb + k, dtype=np.int64)])
        self._risk_cache = None
        self.jobs_on_host.extend(set() for _ in range(k))
        self.hosts += k
        self._idle_chips += int(caps.sum())
        if self.speeds is None:
            self._idle_eff = float(self._idle_chips)
        else:
            self._idle_eff += float(
                (caps * self.speeds[new_idx]).sum())
            self._hetero = bool((self.speeds != self.speeds[0]).any())
        return new_idx

    def drain_hosts(self, hosts: Sequence[int]) -> None:
        """Begin a lease reclaim (a FleetEvent ``reclaim``): the hosts
        take no new placements (their free chips are surrendered to the
        provider immediately; capacity shrinks to current usage) and
        chips later freed on them retire instead of re-entering the
        pool.  Gangs still running there are the caller's problem:
        ``evacuation_plan`` for the graceful path, ``fail_hosts`` when
        the drain deadline expires."""
        for h in hosts:
            h = int(h)
            if self.draining[h]:
                continue
            f = int(self.free[h])
            if f:
                self._take([(h, f)])     # leaves the idle summaries
            self.capacities[h] -= f
            self.draining[h] = True
        self._any_draining = bool(self.draining.any())

    def fail_hosts(self, hosts: Sequence[int]) -> List[str]:
        """Hard host failure (a FleetEvent ``fail``, or a drain deadline
        expiring): every gang touching a failed host loses its whole
        allocation — chips on surviving hosts return to the pool, chips
        on the failed hosts vanish, and the host's capacity drops to 0
        (the slot stays, dead, so indices never shift).  Returns the
        job_ids that lost chips; the caller requeues each from its last
        checkpoint (the Faasm-style snapshot recovery path)."""
        dead = {int(h) for h in hosts}
        victims = [a for a in self.allocations.values()
                   if any(h in dead for h, _ in a.placement)]
        for a in victims:
            for h, _ in a.placement:
                self.jobs_on_host[h].discard(a.job_id)
            survivors = [(h, c) for h, c in a.placement
                         if h not in dead]
            if survivors:
                self._give(survivors)    # draining hosts retire instead
            self.allocations.pop(a.job_id)
        for h in dead:
            f = int(self.free[h])
            if f:
                self._take([(h, f)])
            self.capacities[h] = 0
            self.draining[h] = False
        self._any_draining = bool(self.draining.any())
        return [a.job_id for a in victims]

    def evacuation_plan(self, hosts: Optional[Sequence[int]] = None,
                        kinds: Optional[Mapping[str, str]] = None
                        ) -> Tuple[List[Tuple[str, Placement]], List[str]]:
        if not telemetry.get().enabled:
            return self._evacuation_impl(hosts, kinds=kinds)
        t0 = time.perf_counter()
        plans, stranded = self._evacuation_impl(hosts, kinds=kinds)
        self._record_decision("evacuation_plan", t0, plans=len(plans),
                              n=len(stranded))
        return plans, stranded

    def _evacuation_impl(self, hosts: Optional[Sequence[int]] = None,
                         kinds: Optional[Mapping[str, str]] = None
                         ) -> Tuple[List[Tuple[str, Placement]],
                                    List[str]]:
        """Plan moves off doomed hosts (``hosts``; default: everything
        draining) — the graceful-drain half of a lease reclaim.

        Each affected granular gang is re-placed with the greedy fill
        over the surviving free chips plus its own chips on safe hosts
        (on heterogeneous fleets the cost model picks between the
        throughput-ordered and plain greedy candidates under the gang's
        job kind, exactly like ``migration_plan``'s hetero move).  Plans
        share one scratch map so they never double-book, and the caller
        applies them through ``apply_migration`` — the same machinery as
        barrier migration, which retires the vacated draining chips via
        ``_give``.  Returns ``(plans, stranded)``: stranded gangs (no
        fit, or slice allocations, which never migrate) run until the
        drain deadline and then hard-fail.  Evacuation is a global
        (cross-shard) decision by construction — a whole shard may be
        draining — so the sharded engine inherits this unchanged."""
        # every draining host is doomed regardless of which reclaim this
        # pass is for: fold the full draining set into the mask so a
        # gang's keep-credit on an *earlier* reclaim's host is never
        # counted as a landing spot (overlapping reclaims)
        mask = self.draining.copy()
        if hosts is not None:
            mask[[int(h) for h in hosts]] = True
        free = self.free.copy()
        free[mask] = 0                   # never evacuate *onto* doom
        hetero = self.heterogeneous
        model = self.cost_model
        plans: List[Tuple[str, Placement]] = []
        stranded: List[str] = []
        for alloc in list(self.allocations.values()):
            if not any(mask[h] for h, _ in alloc.placement):
                continue
            if alloc.slice_size:
                stranded.append(alloc.job_id)
                continue
            keep = [(h, c) for h, c in alloc.placement if not mask[h]]
            for h, c in keep:
                free[h] += c             # own safe chips are reusable
            if hetero:
                kind = (kinds or {}).get(alloc.job_id)
                cands = [p for p in (
                    _greedy_most_free(free, alloc.n, self.speeds),
                    _greedy_most_free(free, alloc.n)) if p is not None]
                cand = min(cands, key=lambda p: model.score(
                    p, kind, self.speeds)) if cands else None
            else:
                cand = _greedy_most_free(free, alloc.n)
            if cand is None:
                for h, c in keep:
                    free[h] -= c
                stranded.append(alloc.job_id)
                continue
            for h, c in cand:
                free[h] -= c
            plans.append((alloc.job_id, cand))
        return plans, stranded

    def shrink_plan(self, worlds: Sequence[int],
                    credit: Sequence[Tuple[int, int]] = (),
                    avoid: Sequence[int] = (),
                    policy: Union[str, PlacementPolicy, None] = None,
                    kind: Optional[str] = None
                    ) -> Optional[Placement]:
        if not telemetry.get().enabled:
            return self._shrink_impl(worlds, credit=credit, avoid=avoid,
                                     policy=policy, kind=kind)
        t0 = time.perf_counter()
        p = self._shrink_impl(worlds, credit=credit, avoid=avoid,
                              policy=policy, kind=kind)
        self._record_decision("shrink_plan", t0,
                              n=max(worlds) if len(worlds) else 0,
                              placed=p is not None, policy=policy,
                              kind=kind)
        return p

    def _shrink_impl(self, worlds: Sequence[int],
                     credit: Sequence[Tuple[int, int]] = (),
                     avoid: Sequence[int] = (),
                     policy: Union[str, PlacementPolicy, None] = None,
                     kind: Optional[str] = None
                     ) -> Optional[Placement]:
        """Shrink-before-rollback (DESIGN.md §13): the largest world in
        ``worlds`` (descending; see ``elastic.shrink_worlds``) placeable
        on surviving capacity — draining hosts and ``avoid`` are
        excluded, and the stranded gang's own chips on safe hosts
        (``credit``) count as landing room.  Returns the placement for
        the first world that fits, or None when checkpoint rollback is
        the only option left.  Like ``evacuation_plan`` this is a
        global (cross-shard) recovery decision, so the sharded engine
        inherits it unchanged."""
        pol = self._resolve(policy)
        free = self.free.copy()
        if self._any_draining:
            free[self.draining] = 0
        for h in avoid:
            free[int(h)] = 0
        for h, c in credit:
            free[h] += c
        for w in worlds:
            p = pol.place(self.view_with(free), w, kind=kind)
            if p is not None:
                return p
        return None


# ---------------------------------------------------------------------------
# Sharded engine (decentralised scheduling, the Fig 11 fix)
# ---------------------------------------------------------------------------
class _ShardScope:
    """Engine-like facade over one shard for ``PreemptPolicy.plan``:
    shard-slice free map, shard-local allocation table (local host
    indices), shard-slice policy views.  Victim ids come back unchanged,
    so a shard-local plan drops straight into the caller's checkpoint +
    requeue path."""

    def __init__(self, engine: "ShardedPlacementEngine", shard: int):
        lo, hi = engine.shard_bounds[shard]
        self._engine = engine
        self._shard = shard
        self._lo, self._hi = lo, hi
        self.free = engine.free[lo:hi]
        self.draining = engine.draining[lo:hi]
        self.default_policy = engine.default_policy
        self.cost_model = engine.cost_model
        self.allocations = {
            a.job_id: Allocation(a.job_id,
                                 [(h - lo, c) for h, c in a.placement],
                                 slice_size=a.slice_size)
            for a in engine.allocations.values()
            if engine.shard_of_gang(a) == shard}

    def view_with(self, free: np.ndarray) -> ClusterView:
        e, lo, hi = self._engine, self._lo, self._hi
        ctx = e._risk_context()
        return ClusterView(free, e.chips_per_host, e.capacities[lo:hi],
                           None if e.speeds is None else e.speeds[lo:hi],
                           hetero=e.shard_hetero[self._shard],
                           risk=None if ctx is None
                           else ctx.sliced(lo, hi))


class ShardedPlacementEngine(PlacementEngine):
    """Decentralised placement: the fleet is partitioned into host-group
    shards of ``hosts_per_shard`` consecutive hosts (ragged last shard),
    and a placement decision touches O(chips_needed + shards) state
    instead of O(hosts):

    1. the *summary index* — per-shard idle chips, idle (speed-weighted)
       throughput, and max contiguous free block, all maintained
       incrementally on commit/release — picks candidate shards:
       shards that could co-locate the gang on one host first, then by
       idle throughput (binpack's most-free-first, at shard granularity);
    2. the policy runs on the chosen shard's O(hosts_per_shard) slice
       only; a miss *forwards* to the next candidate shard
       (``decision_hops`` counts the extra shards consulted — the
       simulator charges them as forwarding latency);
    3. a gang no single shard can hold is *split*: shards contribute
       greedily in summary order, each placing its part locally.

    Accounting stays global (one free map, one allocation table), so
    release / bind / reservations / ``apply_migration`` are inherited
    unchanged and consumers see the exact ``PlacementEngine`` interface.
    ``migration_plan`` and ``preemption_plan`` run shard-locally for
    gangs inside one shard, with an explicit cross-shard escalation
    path (global planning) for gangs or arrivals that span shards.

    With a single shard covering the whole fleet every decision —
    placement, migration, preemption — is bit-identical to the
    centralised engine, and ``decision_hops`` stays 0.

    ``hosts_per_shard="auto"`` sizes shards from the fleet
    (``auto_shard_hosts``) and re-balances as fleet churn moves the
    live host count; a numeric spec keeps its fleet-size clamp across
    joins.  ``steal_budget`` caps cross-shard forwards / splits /
    preemption escalations per scheduling pass (reset once per queue
    pump by the simulator; 0 = unbounded, bit-identical) so a
    churn-thrashed backlog cannot hammer the summary index.
    """

    def __init__(self, hosts: int, chips_per_host: int,
                 hosts_per_shard: Union[int, str] = DEFAULT_SHARD_HOSTS,
                 steal_budget: int = 0, **kwargs):
        super().__init__(hosts, chips_per_host, **kwargs)
        # "auto" sizes shards from the fleet (auto_shard_hosts) and
        # re-sizes them as churn changes the live host count; a numeric
        # spec is fixed for the engine's lifetime
        self._shard_spec: Union[int, str] = hosts_per_shard
        if hosts_per_shard == "auto":
            hosts_per_shard = auto_shard_hosts(hosts)
        assert int(hosts_per_shard) > 0
        self.hosts_per_shard = min(int(hosts_per_shard), hosts)
        # steal budget: cross-shard split / escalation attempts allowed
        # per scheduling pass (0 = unbounded — the pre-budget
        # behaviour, bit-identical); the simulator resets it once per
        # queue pump so a churn-thrashed backlog cannot hammer the
        # summary index with hopeless cross-shard work
        self.steal_budget = steal_budget
        self._steal_left: float = float("inf")
        self.reset_steal_budget()
        self._rebuild_shards()

    def _rebuild_shards(self) -> None:
        """(Re)compute shard bounds and the summary index from the live
        free map — run at construction and after fleet churn changes
        the host count (``add_hosts``) or the adaptive shard size.
        Dead/retired host slots stay inside their shard at capacity 0;
        summaries are exact by construction."""
        hosts = self.hosts
        self.shard_bounds: List[Tuple[int, int]] = [
            (lo, min(lo + self.hosts_per_shard, hosts))
            for lo in range(0, hosts, self.hosts_per_shard)]
        self.n_shards = len(self.shard_bounds)
        self._shard_of = np.repeat(np.arange(self.n_shards),
                                   [hi - lo for lo, hi
                                    in self.shard_bounds])
        # summary index: incrementally maintained on every _take/_give
        self._shard_idle = np.array(
            [int(self.free[lo:hi].sum()) for lo, hi in self.shard_bounds],
            dtype=np.int64)
        self._shard_eff = np.array(
            [float(self._shard_idle[s]) if self.speeds is None
             else float((self.free[lo:hi] * self.speeds[lo:hi]).sum())
             for s, (lo, hi) in enumerate(self.shard_bounds)])
        self._shard_max = np.array(
            [int(self.free[lo:hi].max()) for lo, hi in self.shard_bounds],
            dtype=np.int64)
        self._shard_dirty = np.zeros(self.n_shards, dtype=bool)
        self.shard_hetero = [
            self.speeds is not None and bool(
                (self.speeds[lo:hi] != self.speeds[lo]).any())
            for lo, hi in self.shard_bounds]

    # ---- fleet churn --------------------------------------------------------
    def reset_steal_budget(self) -> None:
        self._steal_left = (float("inf") if not self.steal_budget
                            else float(self.steal_budget))

    def _spend_steal(self) -> bool:
        """Consume one cross-shard attempt; False when exhausted."""
        if self._steal_left <= 0:
            return False
        self._steal_left -= 1
        return True

    def _maybe_resize_shards(self) -> bool:
        """Resharding hook: churn that moves the host count re-derives
        the shard size from the original spec — ``"auto"`` re-balances
        against the live host count, a numeric spec re-applies its
        fleet-size clamp (so a spec covering the whole fleet keeps
        covering it after joins: single-shard parity with the
        centralised engine survives growth).  True when it changed."""
        if self._shard_spec == "auto":
            want = min(auto_shard_hosts(max(1, self.alive_hosts())),
                       self.hosts)
        else:
            want = min(int(self._shard_spec), self.hosts)
        if want == self.hosts_per_shard:
            return False
        self.hosts_per_shard = want
        return True

    def add_hosts(self, capacities: Sequence[int],
                  speeds: Optional[Sequence[float]] = None) -> List[int]:
        new_idx = super().add_hosts(capacities, speeds)
        self._maybe_resize_shards()
        self._rebuild_shards()          # new hosts need shard membership
        return new_idx

    def fail_hosts(self, hosts: Sequence[int]) -> List[str]:
        out = super().fail_hosts(hosts)
        # host slots persist (indices never shift), so only an adaptive
        # size change forces a rebuild — summaries already track the
        # retired chips through the _take/_give funnels
        if self._maybe_resize_shards():
            self._rebuild_shards()
        return out

    @property
    def sched_hosts(self) -> int:
        """One decision scans one shard, not the fleet — the latency
        term the simulator's ``sched="sharded"`` mode charges."""
        return self.hosts_per_shard

    def clone_empty(self) -> "ShardedPlacementEngine":
        eng = ShardedPlacementEngine(
            self.hosts, self.chips_per_host,
            hosts_per_shard=self._shard_spec,
            steal_budget=self.steal_budget,
            policy=self.default_policy, capacities=list(self.capacities),
            speeds=None if self.speeds is None else list(self.speeds),
            cost_model=self.cost_model)
        self._copy_risk_to(eng)
        return eng

    # ---- summary index ------------------------------------------------------
    def _take(self, placement: Sequence[Tuple[int, int]]) -> None:
        super()._take(placement)
        self._shard_delta(placement, -1)

    def _give(self, placement: Sequence[Tuple[int, int]]) -> None:
        # split off draining-host retirements BEFORE the shard delta:
        # retired chips never re-enter a shard's idle summary (the base
        # second pass then finds nothing draining left to filter)
        if self._any_draining:
            placement = self._retire_draining(placement)
            if not placement:
                return
        super()._give(placement)
        self._shard_delta(placement, +1)

    def _shard_delta(self, placement: Sequence[Tuple[int, int]],
                     sign: int) -> None:
        for h, c in placement:
            s = int(self._shard_of[h])
            self._shard_idle[s] += sign * c
            if self.speeds is not None:
                self._shard_eff[s] += sign * c * float(self.speeds[h])
            else:
                self._shard_eff[s] = float(self._shard_idle[s])
            self._shard_dirty[s] = True

    def _shard_risk_eff(self, kind: Optional[str]
                        ) -> Optional[np.ndarray]:
        """Summary index under risk: per-shard idle throughput with
        each host's contribution scaled by its risk discount — the
        lease/hazard metadata's entry into shard ranking, so decisions
        forward toward shards of safe capacity first.  One vectorized
        O(hosts) bincount, paid only in risk-aware mode (None keeps
        the exact incremental ``_shard_eff`` ordering)."""
        ctx = self._risk_context()
        if ctx is None:
            return None
        disc = ctx.discounts(kind)
        if disc is None:
            return None
        w = self.free * disc
        if self.speeds is not None:
            w = w * self.speeds
        return np.bincount(self._shard_of, weights=w,
                           minlength=self.n_shards)

    def _shard_max_free(self) -> np.ndarray:
        """Max contiguous free block per shard (lazily refreshed for
        shards whose free map moved since the last read)."""
        for s in np.nonzero(self._shard_dirty)[0]:
            lo, hi = self.shard_bounds[int(s)]
            self._shard_max[s] = int(self.free[lo:hi].max())
        self._shard_dirty[:] = False
        return self._shard_max

    def shard_of_gang(self, alloc: Allocation) -> Optional[int]:
        """The shard an allocation lives in, or None when it spans."""
        shards = {int(self._shard_of[h]) for h, _ in alloc.placement}
        return shards.pop() if len(shards) == 1 else None

    def _shard_view(self, shard: int) -> ClusterView:
        lo, hi = self.shard_bounds[shard]
        ctx = self._risk_context()
        return ClusterView(self.free[lo:hi], self.chips_per_host,
                           self.capacities[lo:hi],
                           None if self.speeds is None
                           else self.speeds[lo:hi],
                           hetero=self.shard_hetero[shard],
                           idle=int(self._shard_idle[shard]),
                           idle_eff=float(self._shard_eff[shard]),
                           risk=None if ctx is None
                           else ctx.sliced(lo, hi))

    # ---- placement ----------------------------------------------------------
    def _reserve_impl(self, n: int,
                      policy: Union[str, PlacementPolicy, None] = None,
                      kind: Optional[str] = None) -> Optional[Reservation]:
        pol = self._resolve(policy)
        self.decision_hops = 0
        if not self.external_budget_reset:
            self.reset_steal_budget()    # direct use: per-decision cap
        if n > self._idle_chips:
            return None
        consults = 0
        placement: Optional[Placement] = None
        # home shard first, then forward: shards that can co-locate the
        # gang on one host, then by idle throughput (summary index only
        # — no shard state is touched until the policy runs)
        fits_host = self._shard_max_free() >= n
        candidates = np.nonzero(self._shard_idle >= n)[0]
        if candidates.size:
            eff = self._shard_risk_eff(kind)
            if eff is None:
                eff = self._shard_eff
            order = candidates[np.lexsort(
                (-eff[candidates],
                 ~fits_host[candidates]))]
            for s in order:
                # forwarding beyond the home shard spends steal budget
                # (with budget 0 = unbounded this never breaks)
                if consults >= 1 and not self._spend_steal():
                    break
                lo, _ = self.shard_bounds[int(s)]
                local = pol.place(self._shard_view(int(s)), n, kind=kind)
                consults += 1
                if local is not None:
                    placement = sorted((h + lo, c) for h, c in local)
                    break
        if placement is None:
            if not self._spend_steal():  # a split is a cross-shard steal
                return None
            placement, split_consults = self._split_place(pol, n, kind)
            consults += split_consults
            if placement is None:
                return None
        self.decision_hops = consults - 1
        self._take(placement)           # per-host conservation asserts
        return Reservation(placement, slice_size=pol.slice_size)

    def _split_place(self, pol: PlacementPolicy, n: int,
                     kind: Optional[str]
                     ) -> Tuple[Optional[Placement], int]:
        """Cross-shard split for a gang no single shard can hold:
        shards contribute greedily in idle-throughput order, each
        placing its part through the policy on its own slice."""
        order = np.nonzero(self._shard_idle > 0)[0]
        eff = self._shard_risk_eff(kind)
        if eff is None:
            eff = self._shard_eff
        order = order[np.lexsort((-eff[order],))]
        parts: Placement = []
        remaining = n
        consults = 0
        for s in order:
            lo, _ = self.shard_bounds[int(s)]
            take = min(int(self._shard_idle[s]), remaining)
            view = self._shard_view(int(s))
            local = None
            while take > 0:
                local = pol.place(view, take, kind=kind)
                if local is not None:
                    break
                take -= 1           # slice policies may need fewer chips
            consults += 1
            if local is None:
                continue
            parts.extend((h + lo, c) for h, c in local)
            remaining -= sum(c for _, c in local)
            if remaining <= 0:
                break
        if remaining > 0:
            return None, consults
        return sorted(parts), consults

    # ---- preemption ---------------------------------------------------------
    def _preemption_impl(self, n: int, priority: int,
                         priorities: Dict[str, int],
                         policy: Union[str, PlacementPolicy, None] = None,
                         preempt: Optional[PreemptPolicy] = None,
                         kind: Optional[str] = None
                         ) -> Optional[List[str]]:
        """Shard-local victim planning: each shard (by idle throughput)
        plans against its own gangs and fit-probes its own slice, so the
        arrival lands entirely inside the shard that evicts for it.
        When no single shard can host the arrival even with evictions,
        the plan *escalates* cross-shard: the centralised planner runs
        over the global table (victims and placement may then span
        shards)."""
        pp = preempt or PreemptPolicy()
        if not self.external_budget_reset:
            self.reset_steal_budget()    # direct use: per-decision cap
        caps = np.array([int(self.capacities[lo:hi].sum())
                         for lo, hi in self.shard_bounds])
        order = np.nonzero(caps >= n)[0]
        order = order[np.lexsort((-self._shard_eff[order],))]
        for s in order:
            scope = _ShardScope(self, int(s))
            local_pri = {jid: priorities.get(jid, 0)
                         for jid in scope.allocations}
            plan = pp.plan(scope, n, priority, local_pri, policy,
                           kind=kind)
            if plan is not None:
                return plan
        if not self._spend_steal():     # escalation is a cross-shard steal
            return None
        return super()._preemption_impl(n, priority, priorities,
                                        policy=policy, preempt=pp,
                                        kind=kind)

    # ---- migration ----------------------------------------------------------
    def _migration_impl(self, allocs: Sequence[Allocation],
                        kinds: Optional[Mapping[str, str]] = None,
                        remaining: Optional[Mapping[str, float]] = None
                        ) -> List[Tuple[str, Placement]]:
        """Shard-local defragmentation: a gang inside one shard is
        re-planned against that shard's slice only (moves never leave
        the shard); a gang already spanning shards escalates to global
        planning.  One global scratch map keeps shard-local and
        escalated plans from double-booking each other."""
        plans = []
        free = self.free.copy()
        drain = self.draining if self._any_draining else None
        for alloc in allocs:
            shard = self.shard_of_gang(alloc)
            kind = (kinds or {}).get(alloc.job_id)
            rem = (remaining or {}).get(alloc.job_id)
            if shard is None:                 # spans shards: escalate
                new = self._plan_move(free, alloc, alloc.placement,
                                      self.heterogeneous, self.speeds,
                                      kind, rem, draining=drain)
            else:
                lo, hi = self.shard_bounds[shard]
                local = [(h - lo, c) for h, c in alloc.placement]
                new = self._plan_move(
                    free[lo:hi], alloc, local, self.shard_hetero[shard],
                    None if self.speeds is None else self.speeds[lo:hi],
                    kind, rem,
                    draining=None if drain is None else drain[lo:hi])
                if new is not None:
                    new = [(h + lo, c) for h, c in new]
            if new is not None:
                plans.append((alloc.job_id, new))
        return plans
