"""Discrete-event simulator of job traces on a shared cluster (paper §6).

The paper's evaluation is a *scheduling-policy* experiment: 100-job traces
of MPI (LAMMPS) and OpenMP (DGEMM) jobs on 32 8-vCPU VMs, comparing
Faabric's chip-granular Granule scheduling (+ barrier-point migration)
against fixed-slice container baselines.  That experiment is hardware-
independent given a job-time model; we reproduce it with a model calibrated
from the paper's own microbenchmarks:

* job time: the shared ``core.placement.CostModel``
  T = (W / sum_h n_h*s_h) * (1 + beta_kind * chi), with chi the cross-host
  pair fraction of the gang placement
  (``Allocation.cross_host_fraction``), per-host speed factors ``s_h``
  (mixed host generations — ``hetero_speeds`` builds the half-the-fleet-
  at-s=0.5 regime), and per-job-kind beta calibrated from Fig 14:
  compute-bound LAMMPS co-located vs 4+4-fragmented = 1.2x  -> beta = 0.4;
  network-bound all-to-all = 7.5x -> beta = 13.0.  The same model scores
  policy candidates, costs migration plans, and integrates job rates, so
  placement and execution agree by construction.
* runtime overhead: Faabric's shared-memory (OpenMP) jobs carry a 1.25x
  execution-time factor (paper §6.4: 20–30% WASM floating-point overhead).
* migration: at barrier control points a fragmented gang may be
  consolidated; cost = snapshot transfer (Fig 14: worth it except >80%
  progress for compute-bound jobs).
* centralised-scheduler latency: a per-decision cost proportional to the
  host count one decision scans, charged once per scheduling pass
  (reproduces the 128-VM degradation of Fig 11).  ``sched="sharded"``
  runs the ``ShardedPlacementEngine``: a decision scans one host-group
  shard (``SCHED_LATENCY_PER_HOST * hosts_per_shard``) plus
  ``SCHED_FORWARD_HOP_S`` per shard the summary index forwarded it to —
  the decentralised fix the paper leaves open.

Every placement goes through ``core.placement.PlacementEngine`` — the same
code path the live runtime uses — under a selectable policy (binpack /
spread / locality for granular mode; fixed-slice for the baselines).

Beyond the paper's all-jobs-at-t=0 FIFO replay, traces carry per-job
**arrival times** (e.g. Poisson arrivals) and **priority classes**; the
queue is ordered (priority desc, arrival, submission), and optional
**backfill** lets queued jobs jump past a blocked head-of-line job — the
shared-cluster, multi-tenant economics of §2.1.  With all arrivals at t=0,
uniform priority, and backfill off, the event loop is exactly the paper's
FIFO experiment.  ``preempt`` adds rFaaS-style lease reclamation: a
high-priority arrival that cannot be placed evicts lower-priority gangs
(``PlacementEngine.preemption_plan``) — the victim is checkpointed
(progress survives), requeued, and pays a snapshot restore cost when it
resumes.

Scheduling decisions are logged as ``core.control.Action`` records —
the same action vocabulary (checkpoint / migrate / rescale / preempt /
start / finish) the live runtime's control points consume, so a simulated
trace and a ``core.fabric.Fabric.run_trace`` execution of the same trace
can be diffed event-by-event.

**Fleet churn** (``core.fleet``): ``run(jobs, fleet_events=...)``
interleaves host joins, lease reclaims (drain for ``drain_s``, then the
host dies) and hard failures with the arrival trace.  Gangs on a
draining host evacuate through the shared evacuation planner (charged
like a migration); gangs on a failed host are requeued from their last
checkpoint — ``checkpoint_interval`` adds a periodic checkpoint cadence
(each costs ``CostModel.checkpoint_cost_s``), and the work since the
last checkpoint is counted in ``TraceResult.lost_work_s`` (the
Young/Daly cadence-vs-lost-work tradeoff of ``bench_churn``).  With no
churn schedule and no checkpoint interval the event loop is
bit-identical to the pre-churn simulator (pinned).

**Risk-aware churn** (DESIGN.md §13): when the engine's ``CostModel``
carries ``risk_tau_s`` the event loop feeds the placement layer's risk
metadata — per-host lease expiries and blast groups read off the churn
schedule at trace start (the contractual part a provider publishes),
plus an online ``fleet.HazardEstimator`` updated at every applied
fleet event — so every policy decision sees the same leases/hazards
the live runtime would.  ``shrink_recovery=True`` adds
shrink-before-rollback: a gang stranded by a drain reshards onto
surviving capacity at a smaller power-of-two world
(``elastic.shrink_worlds``) while its chips are still alive, retried
on the drain's backoff schedule (``FleetController.retry_times``)
through the deadline; a gang stranded by a hard fail shrinks onto the
survivors when it kept at least one live replica chip.  Only when no
shrink world fits does the checkpoint-rollback path run.  Both knobs
default off and the default paths stay bit-identical (pinned).

The event loop exposes overridable hooks (``_on_start`` / ``_on_advance``
/ ``_on_preempt`` / ``_on_migrate`` / ``_on_finish`` and the churn hooks
``_on_join`` / ``_on_drain`` / ``_on_hosts_down`` / ``_on_checkpoint``
/ ``_on_fail``) that are no-ops here; ``core.fabric`` subclasses them
to execute the trace against real gangs while virtual time drives
scheduling.

The simulator is deterministic given a seed.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import placement as placement_mod
from repro_torch.core import telemetry
from repro_torch.core.control import Action
from repro_torch.core.fleet import (FleetController, FleetEvent,
                              HazardEstimator, blast_groups,
                              lease_expiries)
from repro_torch.core.placement import (DEFAULT_SHARD_HOSTS, Allocation,
                                  CostModel, FixedSlicePolicy,
                                  PlacementEngine, PlacementPolicy,
                                  PreemptPolicy, ShardedPlacementEngine,
                                  resolve_policy)

# Fig 14 calibration now lives on core.placement.CostModel (one model for
# policies, simulator, and the live fabric); kept as a read-only copy for
# callers that still read the table directly (mutating it has no effect —
# recalibrate via CostModel(betas=...) instead).
BETA = dict(CostModel.DEFAULT_BETAS)
WASM_OVERHEAD_OMP = 1.25          # paper §6.4
OVERCOMMIT_PENALTY = 1.5          # threads > vCPUs in one container (§6.2)
# Default calibration of CostModel.migration_cost_s / preempt_cost_s;
# the event loop charges whatever the engine's model carries, so a
# custom model keeps the plan filter and the simulated charge in sync.
MIGRATION_COST_S = 2.0            # snapshot transfer at a barrier point
PREEMPT_COST_S = 2.0              # snapshot restore when a victim resumes
SCHED_LATENCY_PER_HOST = 0.004    # centralised scheduler cost (Fig 11)
# sharded scheduling (the Fig 11 fix): one decision scans one shard
# (SCHED_LATENCY_PER_HOST * hosts_per_shard) and pays this much per
# forwarding hop — a summary-index lookup + RPC to a peer shard, far
# cheaper than scanning the peer's hosts
SCHED_FORWARD_HOP_S = 0.002


@dataclasses.dataclass
class Job:
    job_id: str
    kind: str                     # mpi-compute | mpi-network | omp
    parallelism: int              # MPI world size / OMP_NUM_THREADS
    work: float                   # chip-seconds at perfect scaling
    arrival: float = 0.0          # submission time (0 = paper's replay)
    priority: int = 0             # higher runs first
    workload: str = ""            # live-execution payload: train | serve


@dataclasses.dataclass
class RunningJob:
    job: Job
    alloc: Allocation
    start: float
    progress: float = 0.0         # fraction of work done
    last_update: float = 0.0
    eff_parallelism: int = 0
    finish_event: int = -1        # heap token (lazy deletion)
    model: CostModel = dataclasses.field(default_factory=CostModel)
    speeds: Optional[np.ndarray] = None      # engine's per-host factors
    _rate: Optional[float] = None            # cache; placement-invariant
    # fleet churn: progress captured by the last checkpoint (what a
    # hard host failure rolls back to) and its heap token
    ckpt_progress: float = 0.0
    ckpt_event: int = -1
    # periodic checkpoints taken this run segment (index 0 = the
    # baseline at start): drives CostModel.checkpoint_cost's full-vs-
    # delta charging, reset by requeue so live GangHandle chains (which
    # rebase on fail/resume) and the simulator stay in lockstep
    ckpt_count: int = 0
    # shrink-before-rollback: the gang's current DP world when it has
    # been resharded below the submitted parallelism (None = full
    # width); a later rollback requeues the *original* Job, so shrink
    # never sticks past a recovery
    world: Optional[int] = None

    def rate(self) -> float:
        """Fraction of work per second under the current placement —
        the CostModel's T inverted: speed-weighted parallelism over
        work·(1 + beta_kind·chi)·runtime overheads.

        The value only changes when the placement does, so it is cached
        and invalidated by ``invalidate_rate()`` on migration — the
        event loop integrates progress for every running job at every
        event, and the old per-call recomputation dominated large-fleet
        replays (``reference_loops()`` restores it for A/B benchmarks).
        """
        if self._rate is not None and placement_mod._VECTORIZED:
            return self._rate
        j = self.job
        overhead = self.model.slowdown(self.alloc.placement, j.kind)
        runtime = WASM_OVERHEAD_OMP if (
            j.kind == "omp" and self.alloc.slice_size == 0) else 1.0
        world = self.world if self.world is not None else j.parallelism
        if world > self.alloc.n:             # overcommitted container
            runtime *= OVERCOMMIT_PENALTY
        eff = self.model.effective_parallelism(
            self.alloc.placement, self.speeds,
            active=self.eff_parallelism)
        self._rate = eff / (self.job.work * overhead * runtime)
        return self._rate

    def invalidate_rate(self) -> None:
        self._rate = None


@dataclasses.dataclass
class TraceResult:
    makespan: float
    exec_times: List[float]
    idle_samples: List[Tuple[float, float]]   # (time, idle_fraction)
    migrations: int
    waited: List[float]
    queue_drain_time: float = 0.0             # when the job queue emptied
    cross_host_fractions: List[float] = dataclasses.field(
        default_factory=list)                 # chi at placement, per job
    preemptions: int = 0
    finish_order: List[str] = dataclasses.field(default_factory=list)
    finish_times: Dict[str, float] = dataclasses.field(default_factory=dict)
    actions: List[Action] = dataclasses.field(default_factory=list)
    # fleet churn: gangs requeued from a checkpoint after a host
    # failure, seconds of work rolled back, and graceful drain moves
    recoveries: int = 0
    lost_work_s: float = 0.0
    evacuations: int = 0
    # shrink-before-rollback: gangs saved by resharding onto surviving
    # capacity instead of rolling back to checkpoint, and shrunk gangs
    # restored to their submitted width once capacity returned
    shrinks: int = 0
    regrows: int = 0
    # migrations the straggler detector triggered (Actions with
    # payload reason="straggler") — 0 in pure simulation, which never
    # models stragglers, so pinned traces stay bit-compatible
    straggler_migrations: int = 0

    def makespans(self, jobs: Sequence[Job]) -> Dict[str, float]:
        """Per-job makespan (finish - arrival) for the jobs that finished."""
        return {j.job_id: self.finish_times[j.job_id] - j.arrival
                for j in jobs if j.job_id in self.finish_times}

    def mean_cross_host_fraction(self) -> float:
        if not self.cross_host_fractions:
            return 0.0
        return float(np.mean(self.cross_host_fractions))

    def idle_cdf(self, backlogged_only: bool = True) -> np.ndarray:
        """Time-weighted idle-fraction samples for CDF plotting.

        ``backlogged_only`` restricts to the period with queued jobs —
        idle chips then are pure fragmentation waste (the paper's Fig 10
        metric); the drain-down tail would otherwise dominate."""
        samples = self.idle_samples
        if backlogged_only and self.queue_drain_time > 0:
            samples = [s for s in samples
                       if s[0] <= self.queue_drain_time] or samples[:1]
        if len(samples) < 2:
            return np.asarray([samples[0][1]] if samples else [0.0])
        ts = np.array([t for t, _ in samples])
        vals = np.array([v for _, v in samples])
        w = np.diff(ts, append=ts[-1])
        order = np.argsort(vals)
        return np.repeat(vals[order], np.maximum(
            (w[order] / max(ts[-1], 1e-9) * 1000).astype(int), 1))


ARRIVAL_REGIMES = ("poisson", "diurnal", "burst")


def arrival_times(n: int, rate: float, seed: int,
                  regime: str = "poisson", diurnal_amp: float = 0.8,
                  diurnal_period: float = 0.0, burst_factor: float = 4.0,
                  burst_duty: float = 0.15) -> np.ndarray:
    """``n`` open-loop arrival timestamps at mean offered load ``rate``.

    Regimes (all deterministic given ``seed``, mean rate ≈ ``rate``):

    * ``poisson`` — homogeneous: exponential inter-arrival gaps (the
      exact draw sequence ``_assign_arrivals`` has always used).
    * ``diurnal`` — non-homogeneous Poisson, intensity
      ``rate * (1 + amp*sin(2*pi*t/period))`` (day/night swing), sampled
      by Lewis-Shedler thinning.  ``diurnal_period`` defaults to the
      span ``n`` arrivals cover at ``rate``, i.e. one full "day" per
      trace.
    * ``burst`` — baseline load with periodic burst episodes:
      ``burst_factor`` x rate for ``burst_duty`` of each cycle, rebalanced
      below baseline otherwise so the mean stays ``rate`` (flash-crowd
      traffic; the autoscaler stress regime).
    """
    rng = np.random.default_rng([seed, 1])
    if regime == "poisson":
        t, out = 0.0, []
        for _ in range(n):
            t += float(rng.exponential(1.0 / rate))
            out.append(t)
        return np.asarray(out)
    if regime == "diurnal":
        period = diurnal_period or n / max(rate, 1e-9)
        lam_max = rate * (1.0 + diurnal_amp)

        def lam(t):
            return rate * (1.0 + diurnal_amp
                           * np.sin(2.0 * np.pi * t / period))
    elif regime == "burst":
        period = n / max(rate, 1e-9) / 8.0     # several bursts per trace
        low = max(0.05, (1.0 - burst_factor * burst_duty)
                  / max(1e-9, 1.0 - burst_duty))
        lam_max = rate * burst_factor

        def lam(t):
            frac = (t / period) % 1.0
            return rate * (burst_factor if frac < burst_duty else low)
    else:
        raise ValueError(f"unknown arrival regime {regime!r}")
    # thinning: candidate gaps at lam_max, accept with lam(t)/lam_max
    t, out = 0.0, []
    while len(out) < n:
        t += float(rng.exponential(1.0 / lam_max))
        if rng.uniform() * lam_max <= lam(t):
            out.append(t)
    return np.asarray(out)


def generate_trace(n_jobs: int, kind: str, seed: int,
                   chips_per_host: int = 8,
                   arrival_rate: float = 0.0,
                   priority_classes: Optional[Sequence[Tuple[int, float]]]
                   = None, arrival_regime: str = "poisson") -> List[Job]:
    """Paper §6.2 traces: parallelism uniform over [2, 2*chips] for MPI
    (world sizes up to 2 VMs) and [2, chips] for OpenMP.

    ``arrival_rate`` > 0 draws open-loop arrivals from
    ``arrival_times`` under ``arrival_regime`` (poisson / diurnal /
    burst); 0 keeps the paper's all-at-t=0 replay.  ``priority_classes``
    is [(priority, weight)] to sample per-job priority classes.  All
    draws use rng streams separate from the job-size draws, so the base
    trace is identical across regimes.
    """
    rng = np.random.default_rng(seed)
    jobs = []
    for i in range(n_jobs):
        if kind.startswith("mpi"):
            n = int(rng.integers(2, 2 * chips_per_host + 1))
            work = 400.0
        else:
            n = int(rng.integers(2, chips_per_host + 1))
            work = 240.0
        jobs.append(Job(f"{kind}-{i}", kind, n, work))
    return _assign_arrivals(jobs, seed, arrival_rate, priority_classes,
                            arrival_regime)


def _assign_arrivals(jobs: List[Job], seed: int, arrival_rate: float,
                     priority_classes,
                     arrival_regime: str = "poisson") -> List[Job]:
    """Stamp one open-loop arrival process / priority draw over a whole
    trace (rng streams separate from the job-size draws)."""
    if arrival_rate > 0:
        times = arrival_times(len(jobs), arrival_rate, seed,
                              regime=arrival_regime)
        for job, t in zip(jobs, times):
            job.arrival = float(t)
    if priority_classes:
        pri_rng = np.random.default_rng([seed, 2])
        pris = [p for p, _ in priority_classes]
        w = np.asarray([w for _, w in priority_classes], dtype=np.float64)
        picks = pri_rng.choice(len(pris), size=len(jobs), p=w / w.sum())
        for job, k in zip(jobs, picks):
            job.priority = pris[int(k)]
    return jobs


def mixed_trace(n_jobs: int, seed: int, chips_per_host: int = 8,
                arrival_rate: float = 0.0,
                priority_classes: Optional[Sequence[Tuple[int, float]]]
                = None,
                kinds: Sequence[str] = ("mpi-compute", "omp",
                                        "mpi-network"),
                arrival_regime: str = "poisson") -> List[Job]:
    """Interleaved mpi-compute / mpi-network / omp trace — the fragmented
    multi-tenant mix used by the policy-sweep benchmarks.  Arrivals and
    priorities are drawn once over the merged trace, so ``arrival_rate``
    is the aggregate rate (not per job kind).  ``kinds`` reweights the
    interleave (repeat a kind to double its share) — e.g. the
    network-heavy beta-sensitivity line of the bench_makespan hetero
    sweep."""
    per = -(-n_jobs // len(kinds))
    parts = [generate_trace(per, k, seed + i, chips_per_host)
             for i, k in enumerate(kinds)]
    jobs = [parts[i % len(kinds)][i // len(kinds)] for i in range(n_jobs)]
    for i, j in enumerate(jobs):           # unique ids after interleave
        j.job_id = f"mix-{i}-{j.job_id}"
    return _assign_arrivals(jobs, seed, arrival_rate, priority_classes,
                            arrival_regime)


def hetero_speeds(hosts: int, slow_fraction: float = 0.5,
                  slow: float = 0.5, fast: float = 1.0) -> np.ndarray:
    """Mixed-generation host regime for the trace experiments: the first
    ``slow_fraction`` of the fleet is an older host generation at
    per-chip speed ``slow``, the rest run at ``fast`` — e.g. half the
    hosts at s=0.5.  Feed the result to ``Simulator(speeds=...)``,
    ``PlacementEngine(speeds=...)`` or ``Fabric(speeds=...)`` so
    ``generate_trace``/``mixed_trace`` jobs exercise the heterogeneous
    cost-model path end-to-end."""
    n_slow = int(round(hosts * slow_fraction))
    return np.asarray([slow] * n_slow + [fast] * (hosts - n_slow),
                      dtype=np.float64)


class Simulator:
    """Event-driven execution of a job trace on a shared cluster."""

    def __init__(self, hosts: int, chips_per_host: int, mode: str,
                 slice_size: int = 0, migrate: bool = True,
                 barrier_interval: float = 5.0,
                 policy: Union[str, PlacementPolicy] = "binpack",
                 backfill: bool = False,
                 preempt: Union[bool, PreemptPolicy, None] = False,
                 engine: Optional[PlacementEngine] = None,
                 speeds: Optional[Sequence[float]] = None,
                 cost_model: Optional[CostModel] = None,
                 sched: str = "central",
                 shard_hosts: Union[int, str, None] = None,
                 steal_budget: int = 0,
                 checkpoint_interval: Optional[float] = None,
                 shrink_recovery: bool = False):
        """mode: 'granular' (Faabric) or 'slices' (fixed baseline).

        ``policy`` selects the granular placement policy (binpack /
        spread / locality); 'slices' mode always uses fixed slices.
        ``backfill`` lets queued jobs that fit run past a blocked
        head-of-line job (capacity only shrinks while the head waits, so
        no skipped job could have run sooner).
        ``preempt`` enables priority preemption for a blocked
        head-of-line job (granular mode only): ``True`` for the default
        ``PreemptPolicy``, or a configured instance.
        ``speeds`` / ``cost_model`` configure a heterogeneous fleet
        (per-host speed factors, e.g. ``hetero_speeds``) and the shared
        job-time model; both land on the built engine.
        ``sched`` selects the scheduler architecture: 'central' (one
        engine scanning every host — the Fig 11 degradation) or
        'sharded' (``ShardedPlacementEngine`` over host groups of
        ``shard_hosts``; a decision scans one shard and pays
        ``SCHED_FORWARD_HOP_S`` per forwarding hop).  ``shard_hosts``
        may be ``"auto"`` (adaptive shard sizing that re-balances under
        churn) and ``steal_budget`` caps cross-shard split/escalation
        attempts per queue pump (0 = unbounded).
        ``checkpoint_interval`` adds a periodic per-gang checkpoint
        cadence (each charged ``CostModel.checkpoint_cost_s``) — what a
        fleet-churn hard failure rolls a gang back to; None keeps the
        pre-churn behaviour (failures roll back to the last preemption
        checkpoint or job start).
        ``shrink_recovery`` (granular mode) turns on
        shrink-before-rollback: gangs stranded by a drain or hard fail
        first try to reshard onto surviving capacity at a
        ``elastic.shrink_worlds`` world size and only roll back to
        checkpoint when no shrink fits (see the module docstring);
        False keeps the rollback-only recovery path bit-identical.
        ``engine`` adopts an externally-owned (fresh) ``PlacementEngine``
        instead of building one — used by ``core.fabric`` so live
        execution and prediction share one accounting code path; the
        engine's hosts/capacities/speeds/cost-model — and its
        centralised-vs-sharded architecture — override the
        ``hosts``/``chips_per_host``/``speeds``/``cost_model``/``sched``
        args.
        """
        if mode == "slices":
            pol: PlacementPolicy = FixedSlicePolicy(slice_size)
        else:
            pol = policy
        # the trace policy is carried per-call, never written into the
        # engine: an adopted (fabric-owned) engine keeps its own default
        self.policy = resolve_policy(pol)
        if engine is None:
            if sched == "sharded":
                engine = ShardedPlacementEngine(
                    hosts, chips_per_host,
                    hosts_per_shard=shard_hosts or DEFAULT_SHARD_HOSTS,
                    steal_budget=steal_budget,
                    policy=pol, speeds=speeds, cost_model=cost_model)
            else:
                assert sched == "central", f"unknown sched mode {sched!r}"
                engine = PlacementEngine(hosts, chips_per_host,
                                         policy=pol, speeds=speeds,
                                         cost_model=cost_model)
        else:
            assert engine.idle_chips() == engine.total_chips, \
                "adopted engine must be idle at trace start"
        self.engine = engine
        # the event loop owns the steal-budget lifecycle: reset once per
        # queue pump (not per decision — the budget caps a whole pass)
        engine.external_budget_reset = True
        self.model = engine.cost_model
        self.mode = mode
        self.slice_size = slice_size
        self.migrate = migrate and mode == "granular"
        if preempt and mode == "granular":
            self.preempt: Optional[PreemptPolicy] = (
                preempt if isinstance(preempt, PreemptPolicy)
                else PreemptPolicy())
        else:
            self.preempt = None
        self.barrier_interval = barrier_interval
        self.backfill = backfill
        self.checkpoint_interval = checkpoint_interval
        # slice allocations never migrate, so they never shrink either
        self.shrink_recovery = shrink_recovery and mode == "granular"
        # per-decision scheduler latency: the host count one decision
        # scans — the whole fleet for a centralised engine, one shard
        # for a sharded one (+ forwarding hops charged per decision).
        # Refreshed per pump: adaptive resharding under churn changes
        # the shard size mid-trace.
        self.sched_latency = SCHED_LATENCY_PER_HOST * engine.sched_hosts

    # ---- live-execution hooks (no-ops; see core.fabric) --------------------
    def _on_start(self, rj: RunningJob, resumed: bool) -> None:
        pass

    def _on_advance(self, now: float) -> None:
        pass

    def _on_preempt(self, rj: RunningJob) -> None:
        pass

    def _on_migrate(self, rj: RunningJob) -> None:
        pass

    def _on_finish(self, rj: RunningJob) -> None:
        pass

    # fleet-churn hooks (core.fleet events; see LiveTraceRunner)
    def _on_join(self, ev: FleetEvent, new_hosts: List[int]) -> None:
        pass

    def _on_drain(self, ev: FleetEvent) -> None:
        pass

    def _on_hosts_down(self, hosts: Sequence[int]) -> None:
        pass

    def _on_checkpoint(self, rj: RunningJob) -> None:
        pass

    def _on_fail(self, rj: RunningJob, hosts: Sequence[int]) -> None:
        pass

    def _on_shrink(self, rj: RunningJob,
                   survivors: Sequence[Tuple[int, int]]) -> None:
        """A shrink-before-rollback move (or its inverse, a regrow back
        to the submitted width) was applied: ``rj.alloc`` already
        carries the new placement and ``survivors`` the chips that
        still hold a live replica to reshard from (the gang's safe
        chips mid-drain, its surviving chips after a hard fail, or its
        whole shrunken placement on a regrow)."""

    # ---- placement --------------------------------------------------------
    def _try_place(self, job: Job) -> Optional[Allocation]:
        if self.mode != "granular" and job.kind == "omp":
            # shared-memory baseline: exactly one container
            return self.engine.allocate(job.job_id, self.slice_size,
                                        policy=self.policy, kind=job.kind)
        return self.engine.allocate(job.job_id, job.parallelism,
                                    policy=self.policy, kind=job.kind)

    def _eff_parallelism(self, job: Job, alloc: Allocation) -> int:
        # threads overcommit a single container (paper §6.2)
        shared_memory = self.mode != "granular" and job.kind == "omp"
        return self.model.active_workers(job.parallelism, alloc.n,
                                         shared_memory)

    # ---- main loop ----------------------------------------------------------
    def run(self, jobs: List[Job],
            fleet_events: Optional[Sequence[FleetEvent]] = None
            ) -> TraceResult:
        # queue key: (priority desc, arrival, submission order)
        seq = {j.job_id: i for i, j in enumerate(jobs)}

        def qkey(j: Job):
            return (-j.priority, j.arrival, seq[j.job_id])

        queue: List[Job] = sorted((j for j in jobs if j.arrival <= 0),
                                  key=qkey)
        arrivals = sorted((j for j in jobs if j.arrival > 0), key=qkey)
        running: Dict[str, RunningJob] = {}
        heap: List[Tuple[float, int, int, str]] = []
        token = 0
        now = 0.0
        exec_times, waited = [], []
        idle_samples: List[Tuple[float, float]] = []
        chis: List[float] = []
        actions: List[Action] = []
        migrations = preemptions = 0
        recoveries = evacuations = shrinks = regrows = 0
        lost_work = 0.0
        # progress of checkpointed (preempted) jobs awaiting resume
        suspended: Dict[str, float] = {}
        first_start: Dict[str, float] = {}
        finish_order: List[str] = []
        finish_times: Dict[str, float] = {}
        ARRIVE, FINISH, FLEET, DEADLINE, CKPT, RETRY = 0, 1, 2, 3, 4, 5
        for j in arrivals:
            token += 1
            heapq.heappush(heap, (j.arrival, token, ARRIVE, j.job_id))
        pending_arrivals = {j.job_id: j for j in arrivals}
        # fleet churn: events interleave with arrivals on the same heap
        # (at equal timestamps arrivals run first — they were pushed
        # first); the controller owns lease/drain/fail semantics
        schedule = sorted(fleet_events or [], key=lambda e: e.t)
        controller = FleetController(self.engine)
        for i, ev in enumerate(schedule):
            token += 1
            heapq.heappush(heap, (max(0.0, ev.t), token, FLEET, i))
        # risk-aware placement: seed the contractual lease/topology
        # metadata off the schedule (reclaims are sold lease terms,
        # multi-host events reveal blast domains) and estimate hazards
        # online as events are applied — identical in the live runner,
        # which inherits this loop, so predictions stay in parity
        risk_aware = self.model.risk_aware
        hazard_est: Optional[HazardEstimator] = None
        if risk_aware:
            self.engine.set_host_risk(
                lease_until_s=lease_expiries(schedule, self.engine.hosts),
                blast_groups=blast_groups(schedule, self.engine.hosts))
            hazard_est = HazardEstimator(self.engine.hosts)
        if self.shrink_recovery:
            # lazy: core.elastic pulls in jax, which the simulator
            # otherwise never needs
            from repro_torch.core.elastic import shrink_worlds

        def progress_to(t: float):
            # runs for every running job at every event: read the
            # cached per-placement rate directly (reference mode keeps
            # the pre-PR per-call recomputation)
            if placement_mod._VECTORIZED:
                for rj in running.values():
                    r = rj._rate
                    rj.progress += (r if r is not None else rj.rate()) \
                        * (t - rj.last_update)
                    rj.last_update = t
            else:
                for rj in running.values():
                    rj.progress += rj.rate() * (t - rj.last_update)
                    rj.last_update = t

        def schedule_finish(rj: RunningJob):
            nonlocal token
            remaining = max(0.0, 1.0 - rj.progress)
            t_fin = now + remaining / rj.rate()
            token += 1
            rj.finish_event = token
            heapq.heappush(heap, (t_fin, token, FINISH, rj.job.job_id))

        def schedule_ckpt(rj: RunningJob):
            nonlocal token
            if self.checkpoint_interval is None:
                return
            token += 1
            rj.ckpt_event = token
            heapq.heappush(heap, (now + self.checkpoint_interval, token,
                                  CKPT, rj.job.job_id))

        def start_job(job: Job, alloc: Allocation):
            rj = RunningJob(job, alloc, start=now, last_update=now,
                            eff_parallelism=self._eff_parallelism(
                                job, alloc),
                            model=self.model, speeds=self.engine.speeds)
            resumed = job.job_id in suspended
            if resumed:
                # checkpointed progress survives; the snapshot restore
                # costs like a migration
                rj.progress = max(0.0, suspended.pop(job.job_id)
                                  - self.model.preempt_cost_s * rj.rate())
            running[job.job_id] = rj
            if job.job_id not in first_start:
                first_start[job.job_id] = now
                waited.append(now - max(0.0, job.arrival))
            chis.append(alloc.cross_host_fraction())
            actions.append(Action("resume" if resumed else "start",
                                  {"job": job.job_id, "t": now,
                                   "placement": list(alloc.placement)}))
            schedule_finish(rj)
            # a fresh start / restored snapshot IS the baseline
            # checkpoint a later host failure rolls back to
            rj.ckpt_progress = rj.progress
            schedule_ckpt(rj)
            self._on_start(rj, resumed)

        def preempt_for(job: Job) -> bool:
            """Evict lower-priority gangs so the blocked head job fits."""
            priorities = {jid: r.job.priority for jid, r in running.items()}
            plan = self.engine.preemption_plan(
                job.parallelism, job.priority, priorities,
                policy=self.policy, preempt=self.preempt, kind=job.kind)
            if not plan:
                return False
            nonlocal preemptions
            for jid in plan:
                rj = running.pop(jid)
                suspended[jid] = rj.progress   # checkpoint (snapshot)
                self.engine.release(rj.alloc)
                rj.finish_event = -1           # cancel pending finish
                bisect.insort(queue, rj.job, key=qkey)
                preemptions += 1
                actions.append(Action("preempt",
                                      {"job": jid, "t": now,
                                       "by": job.job_id,
                                       "progress": round(rj.progress, 6)}))
                self._on_preempt(rj)
            return True

        def kinds_of() -> Dict[str, str]:
            return {jid: r.job.kind for jid, r in running.items()}

        def fail_jobs(jids: List[str], hosts: Sequence[int]):
            """Requeue gangs that lost chips to a host failure: progress
            rolls back to the last checkpoint, the work since then is
            lost, and the existing suspend/resume machinery (snapshot
            restore cost on resume) brings them back."""
            nonlocal recoveries, lost_work
            for jid in jids:
                rj = running.pop(jid)
                rate = rj.rate()
                lost = (max(0.0, rj.progress - rj.ckpt_progress) / rate
                        if rate > 0 else 0.0)
                lost_work += lost
                suspended[jid] = rj.ckpt_progress
                rj.finish_event = -1
                rj.ckpt_event = -1
                bisect.insort(queue, rj.job, key=qkey)
                recoveries += 1
                actions.append(Action("recover",
                                      {"job": jid, "t": now,
                                       "progress": round(
                                           rj.ckpt_progress, 6),
                                       "lost_s": round(lost, 6)}))
                self._on_fail(rj, hosts)

        def apply_evacuations(plans: List[Tuple[str, list]]):
            """Graceful drain moves: the evacuation planner's decisions,
            applied through the same migration machinery (and charged
            the same snapshot-transfer cost)."""
            nonlocal evacuations
            for jid, new_pl in plans:
                r = running[jid]
                r.alloc = self.engine.apply_migration(r.alloc, new_pl)
                r.invalidate_rate()        # placement changed
                r.progress = max(
                    0.0,
                    r.progress - self.model.migration_cost_s * r.rate())
                evacuations += 1
                actions.append(Action("evacuate",
                                      {"job": jid, "t": now,
                                       "placement": list(new_pl)}))
                self._on_migrate(r)
                schedule_finish(r)

        def apply_shrink(rj: RunningJob, pl: list,
                         survivors: List[Tuple[int, int]],
                         rebind: bool):
            """Commit one shrink-before-rollback move: the gang
            reshards onto ``pl`` (possibly a smaller power-of-two
            world), keeps all its progress, and pays one snapshot
            transfer like a migration.  ``rebind`` distinguishes the
            hard-fail flavour (the engine already dropped the
            allocation) from the mid-drain one (still allocated)."""
            nonlocal shrinks
            old_n = rj.alloc.n
            if rebind:
                rj.alloc = self.engine.bind(rj.job.job_id, pl)
            else:
                rj.alloc = self.engine.apply_migration(rj.alloc, pl)
            # the gang now runs as a world of alloc.n ranks (a DP
            # reshard, not an overcommit); rollback requeues the
            # original Job, so the submitted width is never lost
            rj.world = rj.alloc.n
            rj.eff_parallelism = rj.alloc.n
            rj.invalidate_rate()
            rj.progress = max(
                0.0,
                rj.progress - self.model.migration_cost_s * rj.rate())
            shrinks += 1
            actions.append(Action("shrink",
                                  {"job": rj.job.job_id, "t": now,
                                   "from": old_n, "to": rj.alloc.n,
                                   "placement": list(pl)}))
            self._on_shrink(rj, survivors)
            schedule_finish(rj)

        def shrink_stranded(jids: List[str]):
            """Shrink-before-rollback, drain flavour: a stranded gang's
            draining hosts are still alive, so it can reshard onto safe
            capacity at a smaller world with nothing lost.  Its own
            chips on non-draining hosts count as landing room."""
            for jid in jids:
                rj = running.get(jid)
                if rj is None or rj.alloc.slice_size:
                    continue
                keep = [(h, c) for h, c in rj.alloc.placement
                        if not self.engine.draining[h]]
                pl = self.engine.shrink_plan(
                    shrink_worlds(rj.alloc.n), credit=keep,
                    policy=self.policy, kind=rj.job.kind)
                if pl is not None:
                    apply_shrink(rj, pl, keep, rebind=False)

        def shrink_failed(jids: List[str],
                          hosts: Sequence[int]) -> List[str]:
            """Shrink-before-rollback, hard-fail flavour: the hosts are
            gone (allocations already dropped), so a gang reshards only
            if at least one chip survived to hold a live replica.
            Returns the job_ids with no fitting shrink world — those
            still roll back to checkpoint."""
            dead = {int(h) for h in hosts}
            rollback: List[str] = []
            for jid in jids:
                rj = running.get(jid)
                pl = None
                survivors: List[Tuple[int, int]] = []
                if rj is not None and not rj.alloc.slice_size:
                    survivors = [(h, c) for h, c in rj.alloc.placement
                                 if h not in dead]
                    if survivors:
                        pl = self.engine.shrink_plan(
                            shrink_worlds(rj.alloc.n),
                            policy=self.policy, kind=rj.job.kind)
                if pl is None:
                    rollback.append(jid)
                    continue
                apply_shrink(rj, pl, survivors, rebind=True)
            return rollback

        def regrow_shrunk():
            """A shrink never sticks: once capacity returns (a join, a
            finish), a shrunk gang refits back to its submitted width —
            the inverse move, crediting its current chips as landing
            room and paying one more snapshot transfer.  Runs at the
            head of each scheduling pass so stranded-then-shrunk gangs
            reclaim width before new arrivals soak up the capacity."""
            nonlocal regrows
            for jid in sorted(running):
                rj = running[jid]
                if rj.world is None or rj.world >= rj.job.parallelism:
                    continue
                pl = self.engine.shrink_plan(
                    [rj.job.parallelism], credit=rj.alloc.placement,
                    policy=self.policy, kind=rj.job.kind)
                if pl is None:
                    continue
                old_n = rj.alloc.n
                survivors = list(rj.alloc.placement)
                rj.alloc = self.engine.apply_migration(rj.alloc, pl)
                rj.world = None
                rj.eff_parallelism = self._eff_parallelism(rj.job,
                                                           rj.alloc)
                rj.invalidate_rate()
                rj.progress = max(
                    0.0,
                    rj.progress - self.model.migration_cost_s
                    * rj.rate())
                regrows += 1
                actions.append(Action("regrow",
                                      {"job": jid, "t": now,
                                       "from": old_n,
                                       "to": rj.alloc.n,
                                       "placement": list(pl)}))
                self._on_shrink(rj, survivors)
                schedule_finish(rj)

        def pump_queue():
            # one scheduling pass: the per-decision scan latency accrues
            # ONCE per pump (decisions in a pass share one scan of the
            # fleet/shard state), not once per queued job — the old
            # per-start bump compounded under a deep backlog and pushed
            # the clock far past queued finish events.  Forwarding hops
            # (sharded engine) are genuinely serial per decision and are
            # charged per started job.
            nonlocal now
            # fleet churn: cross-shard steal attempts budget per pass,
            # and adaptive resharding may have changed the shard size
            self.engine.reset_steal_budget()
            if risk_aware:
                # lease clocks tick down: decisions in this pass see
                # remaining lease time as of now
                self.engine.risk_tick(now)
            if self.shrink_recovery:
                regrow_shrunk()
            self.sched_latency = (SCHED_LATENCY_PER_HOST
                                  * self.engine.sched_hosts)
            charged = False
            i = 0
            while i < len(queue):
                job = queue[i]
                alloc = self._try_place(job)
                if alloc is None and i == 0 and self.preempt is not None \
                        and preempt_for(job):
                    alloc = self._try_place(job)
                if alloc is None:
                    if not self.backfill:
                        break
                    i += 1                     # backfill past blocked head
                    continue
                if not charged:
                    now += self.sched_latency
                    charged = True
                now += SCHED_FORWARD_HOP_S * self.engine.decision_hops
                start_job(queue.pop(i), alloc)
            idle_samples.append((now, self.engine.idle_fraction()))

        pump_queue()
        drain_time = 0.0
        while heap:
            t, tok, kind, job_id = heapq.heappop(heap)
            if kind == ARRIVE:
                job = pending_arrivals.pop(job_id)
                now = max(now, t)
                progress_to(now)
                self._on_advance(now)
                bisect.insort(queue, job, key=qkey)
                pump_queue()
                if not pending_arrivals and not queue \
                        and drain_time == 0.0:
                    drain_time = now           # backlog ended mid-arrivals
                continue
            if kind == FLEET:                  # job_id = schedule index
                ev = schedule[job_id]
                now = max(now, t)
                progress_to(now)
                self._on_advance(now)
                out = controller.apply(ev, now, kinds=kinds_of())
                if risk_aware:
                    # after apply: a join's fresh hosts are sized in
                    hazard_est.observe(ev)
                    self.engine.set_host_risk(
                        hazards=hazard_est.rates(self.engine.hosts, now))
                if ev.kind == "join":
                    actions.append(Action("join",
                                          {"t": now,
                                           "hosts": list(out.joined),
                                           "chips": int(sum(
                                               ev.capacities))}))
                    self._on_join(ev, out.joined)
                    pump_queue()               # new capacity may unblock
                elif ev.kind == "fail":
                    actions.append(Action("host-fail",
                                          {"t": now,
                                           "hosts": sorted(
                                               int(h)
                                               for h in ev.hosts)}))
                    self._on_hosts_down(ev.hosts)
                    failed = out.failed
                    if self.shrink_recovery:
                        failed = shrink_failed(failed, ev.hosts)
                    fail_jobs(failed, ev.hosts)
                    pump_queue()               # survivors' chips freed
                else:                          # reclaim: drain begins
                    actions.append(Action("drain",
                                          {"t": now,
                                           "hosts": sorted(
                                               int(h)
                                               for h in ev.hosts),
                                           "deadline": round(
                                               out.deadline, 6)}))
                    self._on_drain(ev)
                    apply_evacuations(out.evacuations)
                    if self.shrink_recovery and out.stranded:
                        shrink_stranded(out.stranded)
                    token += 1
                    heapq.heappush(heap, (out.deadline, token,
                                          DEADLINE, job_id))
                    # evacuation retries through the drain window on
                    # the controller's backoff schedule: capacity that
                    # frees mid-drain rescues gangs before the deadline
                    for rt in controller.retry_times(ev, now):
                        token += 1
                        heapq.heappush(heap, (rt, token, RETRY, job_id))
                continue
            if kind == RETRY:                  # job_id = schedule index
                ev = schedule[job_id]
                # stale once the drain resolved: the deadline already
                # retired the hosts, or nothing still runs on them
                doomed = {int(h) for h in ev.hosts
                          if self.engine.draining[int(h)]}
                if not doomed or not any(
                        any(h in doomed for h, _ in r.alloc.placement)
                        for r in running.values()):
                    continue
                now = max(now, t)
                progress_to(now)
                self._on_advance(now)
                out = controller.expire(ev, kinds=kinds_of())
                apply_evacuations(out.evacuations)
                if self.shrink_recovery and out.stranded:
                    shrink_stranded(out.stranded)
                continue
            if kind == DEADLINE:               # job_id = schedule index
                ev = schedule[job_id]
                now = max(now, t)
                progress_to(now)
                self._on_advance(now)
                # last-chance evacuation (capacity may have freed since
                # the drain began), then the lease is gone: whatever
                # still holds chips requeues from its checkpoint
                out = controller.expire(ev, kinds=kinds_of())
                apply_evacuations(out.evacuations)
                if self.shrink_recovery and out.stranded:
                    # last call with the hosts still alive: a reshard
                    # now keeps progress a rollback would throw away
                    shrink_stranded(out.stranded)
                self._on_hosts_down(ev.hosts)
                failed = controller.fail(ev.hosts)
                actions.append(Action("retire",
                                      {"t": now,
                                       "hosts": sorted(
                                           int(h) for h in ev.hosts),
                                       "failed": list(failed)}))
                if self.shrink_recovery:
                    # chips freed by the retirement itself may fit a
                    # shrink for gangs that kept a surviving replica
                    failed = shrink_failed(failed, ev.hosts)
                fail_jobs(failed, ev.hosts)
                pump_queue()
                continue
            if kind == CKPT:
                rj = running.get(job_id)
                if rj is None or rj.ckpt_event != tok:
                    continue                   # stale (finished/failed)
                t = max(now, t)
                progress_to(t)
                now = t
                self._on_advance(now)
                # the gang pauses for the snapshot save, then the saved
                # progress becomes the failure rollback point; with
                # delta checkpointing configured, non-rebase saves ship
                # chunk diffs and charge the cheaper delta cost
                rj.ckpt_count += 1
                rj.progress = max(
                    0.0,
                    rj.progress
                    - self.model.checkpoint_cost(rj.ckpt_count)
                    * rj.rate())
                rj.ckpt_progress = rj.progress
                actions.append(Action("checkpoint",
                                      {"job": job_id, "t": now,
                                       "progress": round(
                                           rj.progress, 6)}))
                self._on_checkpoint(rj)
                schedule_finish(rj)
                schedule_ckpt(rj)
                continue
            rj = running.get(job_id)
            if rj is None or rj.finish_event != tok:
                continue                            # stale event
            # monotone clock: scheduler-latency bumps during a pump can
            # push `now` past an already-queued finish timestamp
            t = max(now, t)
            progress_to(t)
            now = t
            self._on_advance(now)
            # numerical slack: the job is done
            self.engine.release(rj.alloc)
            del running[job_id]
            exec_times.append(now - first_start[job_id])
            finish_order.append(job_id)
            finish_times[job_id] = now
            actions.append(Action("finish", {"job": job_id, "t": now}))
            self._on_finish(rj)
            # barrier-point migration: consolidate fragmented gangs
            # (only gangs the cost model says can still pay the
            # snapshot cost); plans are costed under each gang's kind
            if self.migrate and running:
                candidates = [r.alloc for r in running.values()
                              if self.model.migration_worthwhile(
                                  r.progress)]
                kinds = {a.job_id: running[a.job_id].job.kind
                         for a in candidates}
                remaining = {
                    a.job_id: max(0.0, 1.0 - running[a.job_id].progress)
                    / running[a.job_id].rate() for a in candidates}
                for jid, new_pl in self.engine.migration_plan(
                        candidates, kinds=kinds, remaining=remaining):
                    r = running[jid]
                    progress_to(now)
                    r.alloc = self.engine.apply_migration(r.alloc, new_pl)
                    r.invalidate_rate()        # placement changed
                    r.progress = max(
                        0.0,
                        r.progress - self.model.migration_cost_s * r.rate())
                    migrations += 1
                    actions.append(Action("migrate",
                                          {"job": jid, "t": now,
                                           "placement": list(new_pl)}))
                    self._on_migrate(r)
                    schedule_finish(r)
            had_queue = bool(queue)
            pump_queue()
            if had_queue and not queue and not pending_arrivals \
                    and drain_time == 0.0:
                drain_time = now
        result = TraceResult(
            makespan=now, exec_times=exec_times,
            idle_samples=idle_samples, migrations=migrations,
            waited=waited, queue_drain_time=drain_time,
            cross_host_fractions=chis,
            preemptions=preemptions,
            finish_order=finish_order,
            finish_times=finish_times, actions=actions,
            recoveries=recoveries, lost_work_s=lost_work,
            evacuations=evacuations, shrinks=shrinks,
            regrows=regrows,
            straggler_migrations=sum(
                1 for a in actions if a.kind == "migrate"
                and a.payload.get("reason") == "straggler"))
        tel = telemetry.get()
        if tel.enabled:
            # render the whole virtual-clock schedule as spans/instants
            # (same schema the live wall-clock spans use) and fold the
            # headline aggregates into the metrics summary
            tel.record_actions(actions, clock="virtual")
            tel.count("sim.runs")
            tel.count("sim.actions", len(actions))
            tel.gauge("sim.makespan_s", now)
            tel.gauge("sim.migrations", migrations)
            tel.gauge("sim.preemptions", preemptions)
        return result


def run_baselines(jobs: List[Job], hosts: int, chips_per_host: int = 8,
                  migrate: bool = True,
                  policy: Union[str, PlacementPolicy] = "binpack",
                  backfill: bool = False,
                  speeds: Optional[Sequence[float]] = None
                  ) -> Dict[str, TraceResult]:
    """Faabric vs the paper's fixed-slice baselines (1/2/4/8 ctr per VM)."""
    out = {}
    out["faabric"] = Simulator(hosts, chips_per_host, "granular",
                               migrate=migrate, policy=policy,
                               backfill=backfill, speeds=speeds).run(jobs)
    for k in (1, 2, 4, 8):
        slice_size = chips_per_host // k
        out[f"{k}-ctr-per-vm"] = Simulator(
            hosts, chips_per_host, "slices", slice_size=slice_size,
            backfill=backfill, speeds=speeds).run(jobs)
    return out
