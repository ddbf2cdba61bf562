"""The shared multi-tenant Fabric: one device pool, many gangs (§2.1;
PyTorch port of ``repro.core.fabric``).

Faabric's core claim is that *many applications share one cluster* under
fine-grained (Granule-level) scheduling with preemption-safe elasticity
and locality-driven migration.  This module is that shared layer for the
live runtime:

* ``Fabric`` owns the device pool — the port's **virtual devices**
  (``core.devices``: ``n_virtual`` slots of one torch device, where the
  JAX fabric takes ``jax.devices()``), the per-host free-device pool
  (including the ragged last host), and the ``PlacementEngine`` that
  every tenant's placement decision goes through.  Multiple gangs
  coexist on one fabric with disjoint device sets; chips released by one
  gang are immediately placeable for another.

* ``GangHandle`` encapsulates one gang's lifecycle::

      allocate -> build mesh/GranuleGroup -> step -> control point
               -> migrate / rescale / preempt -> resume -> release

  Placement changes re-address the ``GranuleGroup`` *in place*
  (``readdress``/``resize``) so rank-keyed control-plane queues and the
  migration epoch survive the move, as the paper requires (Fig 8).
  Workload state moves with ``core.elastic.reshard_gang`` /
  ``core.snapshot``: migrate/rescale copy live state onto the new
  sub-mesh; preempt checkpoints state to a host-side ``Snapshot`` and
  frees the chips; resume restores bit-exactly (fingerprint-verified) on
  a fresh placement.  The virtual devices of one card share a torch
  device, and a move there still copies the state and frees the old
  copy (``reshard_gang``), so its seconds and bytes are measured, not a
  no-op; the gang briefly holds two copies.

* ``LiveTraceRunner`` closes the simulate→execute gap: it subclasses the
  discrete-event ``Simulator`` (``core.simulator``, the JAX module line
  for line) and overrides the event hooks to run *real* train/serve
  gangs on the fabric while virtual time drives scheduling.  Because
  live execution and ``Fabric.predict_trace`` share one event loop and
  one placement code path, the live per-job completion order is directly
  comparable with the simulated prediction for the same trace.

* **Fleet churn, live** (``core.fleet``): hosts lease in and out under
  running gangs.  A ``join`` pulls staged spare devices into the pool;
  a ``reclaim`` drains hosts — affected gangs move through the shared
  evacuation planner — and a hard ``fail`` drops a gang's devices
  mid-run: the gang falls back to its *last checkpoint snapshot*
  (``GangHandle.checkpoint`` / the trace runner's periodic
  ``checkpoint_interval``) and later resumes bit-exactly through the
  same preemption-resume machinery.

Checkpoints are incremental as in the JAX package: a full base, then
chunk diffs (``core.diffsync``) against the previous checkpoint.  The
port diffs the *live* state against the previous checkpoint, so a leaf
on the card is compared there by the diff_merge kernel and only its
dirty chunks are copied to the host; the diff is the one the host
snapshot would give.

Workload protocol (implemented by ``runtime.gang_workloads``): a gang's
payload is any object with

    ``state``                 the gang's state tree — the snapshot /
                              migration unit (None until started)
    ``steps_done`` / ``total_steps`` / ``done``
    ``pods``                  the gang mesh's pod count (1: 1-D)
    ``bind(handle)``          (re)build step fns for ``handle.mesh``;
                              called at start and after every placement
                              change
    ``init_state(handle)``    create ``state`` (first start only)
    ``run_step(handle)``      execute one real step, advance
                              ``steps_done``, return a metrics dict
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import collectives as coll
from repro_torch.core import control as ctl
from repro_torch.core import diffsync
from repro_torch.core import telemetry
from repro_torch.core import elastic as elastic_mod
from repro_torch.core import snapshot as snap_mod
from repro_torch.core.devices import GangMesh, make_gang_mesh, \
    virtual_devices
from repro_torch.core.granule import GranuleGroup
from repro_torch.core.placement import (Allocation, CostModel,
                                        PlacementEngine, PlacementPolicy,
                                        PreemptPolicy,
                                        ShardedPlacementEngine,
                                        derive_capacities)
from repro_torch.core.simulator import Job, Simulator, TraceResult
from repro_torch.weights import tree_leaves, tree_map, tree_unflatten

# Relative per-chip speed by device generation, used to auto-detect a
# mixed-generation pool (unknown kinds count as current-generation 1.0).
DEVICE_KIND_SPEEDS = {
    "TPU v5": 1.0, "TPU v4": 0.75, "TPU v3": 0.45, "TPU v2": 0.25,
    "NVIDIA H100 80GB HBM3": 1.0,
}


def infer_host_speeds(devices: Sequence[Any], chips_per_host: int
                      ) -> Optional[List[float]]:
    """Per-host speed factors for a mixed device pool, or ``None`` for a
    uniform pool (the homogeneous fast path).  Hosts follow the same
    consecutive-run layout as ``derive_capacities``; a host's speed is
    the mean of its devices' generation factors."""
    kinds = [str(getattr(d, "device_kind", "")) for d in devices]
    if len(set(kinds)) <= 1:
        return None
    speeds, i = [], 0
    for cap in derive_capacities(len(devices), chips_per_host):
        factors = [DEVICE_KIND_SPEEDS.get(k, 1.0) for k in kinds[i:i + cap]]
        speeds.append(float(np.mean(factors)))
        i += cap
    return speeds


class GangWorkload:
    """Minimal base for the workload protocol (see module docstring)."""

    state: Any = None
    steps_done: int = 0
    total_steps: int = 0
    pods: int = 1

    @property
    def done(self) -> bool:
        return self.steps_done >= self.total_steps

    def bind(self, handle: "GangHandle") -> None:
        raise NotImplementedError

    def init_state(self, handle: "GangHandle") -> None:
        raise NotImplementedError

    def run_step(self, handle: "GangHandle") -> Dict[str, Any]:
        raise NotImplementedError


def _gang_span(name: str):
    """Wall-clock lifecycle span around a GangHandle method — zero-cost
    (plain call-through) under the default no-op telemetry recorder."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            tel = telemetry.get()
            if not tel.enabled:
                return fn(self, *args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(self, *args, **kwargs)
            finally:
                pl = (self.alloc.placement
                      if self.alloc is not None else [])
                tel.count(f"gang.{name}")
                tel.span_at(f"gang.{name}", t0, time.perf_counter(),
                            track=f"gang:{self.job_id}", clock="wall",
                            job=self.job_id, kind=self.kind,
                            chips=len(self.devices),
                            hosts=len({h for h, _ in pl}))
        return wrapper
    return deco


def _layout(tree):
    """(structure, [(shape, dtype)]) of a state tree."""
    return (tree_map(lambda _: 0, tree),
            [(tuple(t.shape), t.dtype)
             for t in map(diffsync.as_tensor, tree_leaves(tree))])


class GangHandle:
    """One gang's lifecycle on a shared ``Fabric``.

    The handle owns the gang's *placement* artifacts — ``Allocation``,
    virtual devices, ``GranuleGroup``, mesh — and moves the caller's
    (opaque, replicated) state tree through placement changes.  State is
    passed in and returned functionally so drivers keep ownership.
    """

    def __init__(self, fabric: "Fabric", job_id: str, priority: int = 0,
                 pods: int = 1,
                 policy: Union[str, PlacementPolicy, None] = None,
                 kind: Optional[str] = None):
        self.fabric = fabric
        self.job_id = job_id
        self.priority = priority
        self.pods = pods
        self.policy = policy
        self.kind = kind            # trace job kind -> per-kind beta
        self.alloc: Optional[Allocation] = None
        self.devices: List[Any] = []
        self.group: Optional[GranuleGroup] = None
        self.mesh: Optional[GangMesh] = None
        self.snapshot: Optional[snap_mod.Snapshot] = None
        # the periodic checkpoint a hard host failure falls back to
        # (kept separate from ``snapshot``, which preempt/resume consume)
        self.last_checkpoint: Optional[snap_mod.Snapshot] = None
        # delta checkpointing (core.diffsync): after a full base
        # snapshot, each cadence tick ships only the chunk diff against
        # the previous checkpoint; a full rebase every
        # ``ckpt_rebase_every`` ticks bounds the recovery replay chain.
        # Matches CostModel.checkpoint_cost(index) charging: index 0
        # (the start baseline) and every rebase point are full.
        self.ckpt_rebase_every: int = 8
        self._ckpt_base: Optional[snap_mod.Snapshot] = None
        self._ckpt_deltas: List[Dict[str, Any]] = []
        self.ckpt_stats: List[Dict[str, Any]] = []
        self.status = "created"     # created|running|preempted|released
        self.control: Optional[ctl.ControlPointRunner] = None
        self.epoch_log: List[Dict[str, Any]] = []

    @property
    def n(self) -> int:
        return len(self.devices)

    # ---- attach / detach (device + group bookkeeping) ----------------------
    @_gang_span("attach")
    def attach(self, alloc: Allocation,
               devices: Optional[Sequence[Any]] = None) -> None:
        """Bind this gang to an engine allocation: claim concrete devices
        and build (or in-place re-address) the GranuleGroup and mesh."""
        self.alloc = alloc
        self.devices = list(devices if devices is not None
                            else self.fabric.claim(alloc.placement))
        placement = [(self.fabric.host_of(d), d) for d in self.devices]
        if self.group is None:
            self.group = GranuleGroup(self.job_id, len(self.devices),
                                      placement)
        elif self.group.size == len(self.devices):
            self.group.readdress(placement)     # queues + epoch survive
        else:
            self.group.resize(placement)
        self.mesh = make_gang_mesh(self.devices, self.pods)
        self.status = "running"
        self.fabric.tuner.on_placement_change(self.job_id, alloc.placement)

    def detach(self) -> None:
        """Return devices to the fabric pool (engine accounting is the
        caller's: release/preempt handle it in engine-managed mode, the
        trace runner's event loop in adopted mode)."""
        self.fabric.reclaim(self.devices)
        self.devices = []
        self.alloc = None

    # ---- collective schedule dispatch --------------------------------------
    def best_sync_mode(self, nbytes: Optional[int] = None) -> str:
        """The collective schedule the fabric's ``CollectiveTuner``
        dispatches for this gang's *current* placement and message size
        (re-derived on every attach / migrate / evacuate / rescale).
        A single-axis gang mesh (``pods == 1``) has no slow axis to run
        the pod-level compressed schedule over, so the choice is
        restricted accordingly."""
        placement = (self.alloc.placement if self.alloc is not None
                     else [(0, max(1, len(self.devices)))])
        allowed = None if self.pods > 1 else ("flat", "ring",
                                              "hierarchical")
        return self.fabric.tuner.mode_for(placement, nbytes,
                                          allowed=allowed)

    # ---- control point -----------------------------------------------------
    def control_point(self, step: int, step_time: float) -> List[ctl.Action]:
        """Evaluate this gang's step-boundary control point (checkpoint /
        migrate / rescale / recover triggers)."""
        if self.control is None:
            return []
        return self.control.on_step(step, step_time, len(self.devices))

    # ---- migrate / evacuate ------------------------------------------------
    def _log_move(self, kind: str, stats: Dict[str, float],
                  **extra: Any) -> None:
        self.epoch_log.append({"kind": kind, **extra,
                               "epoch": self.group.epoch,
                               "seconds": stats["seconds"],
                               "bytes": stats["bytes"]})

    def _move_to(self, state: Any, new_devices: List[Any],
                 log_kind: str) -> Any:
        """Live placement move: copy state onto ``new_devices`` and
        re-address the group in place (queues + epoch survive)."""
        state, _, stats = elastic_mod.reshard_gang(state, new_devices)
        self.devices = new_devices
        self.group.readdress([(self.fabric.host_of(d), d)
                              for d in new_devices])
        self.mesh = make_gang_mesh(new_devices, self.pods)
        if self.alloc is not None:
            self.fabric.tuner.on_placement_change(self.job_id,
                                                  self.alloc.placement)
        self._log_move(log_kind, stats)
        return state

    @_gang_span("migrate")
    def migrate(self, state: Any) -> Tuple[Any, bool]:
        """Barrier-point live migration (paper §3.3, Fig 8).

        The engine plans a consolidation onto fewer hosts; when none
        exists the gang rotates rank order within its own chips, which
        still exercises the full machinery (barrier, live state copy,
        in-place group re-addressing).  Returns (state, devices_changed).
        """
        assert self.status == "running"
        engine = self.fabric.engine
        plans = engine.migration_plan([self.alloc],
                                      kinds={self.job_id: self.kind})
        if plans:
            _, new_pl = plans[0]
            self.alloc = engine.apply_migration(self.alloc, new_pl)
            self.fabric.reclaim(self.devices)
            new_devices = self.fabric.claim(new_pl)
        else:
            new_devices = self.devices[1:] + self.devices[:1]
        changed = new_devices != self.devices
        state = self._move_to(state, new_devices, "migrate")
        return state, changed

    @_gang_span("evacuate")
    def evacuate(self, state: Any,
                 new_placement: Sequence[Tuple[int, int]]) -> Any:
        """Apply a drain-evacuation plan (``evacuation_plan``): engine
        move + live state copy through the migrate machinery.  The
        vacated draining-host chips retire on release; their devices
        never return to the pool."""
        assert self.status == "running"
        self.alloc = self.fabric.engine.apply_migration(self.alloc,
                                                        new_placement)
        self.fabric.reclaim(self.devices)     # draining devices dropped
        new_devices = self.fabric.claim(new_placement)
        return self._move_to(state, new_devices, "evacuate")

    # ---- rescale -----------------------------------------------------------
    @_gang_span("rescale")
    def rescale(self, state: Any, new_world: int) -> Any:
        """Grow/shrink to ``new_world`` chips: release this gang's chips
        to the shared pool and let the engine carve the new sub-mesh
        under the configured policy (paper §2.1)."""
        assert self.status == "running"
        engine = self.fabric.engine
        new_world = min(new_world, engine.total_chips)
        old_placement = self.alloc.placement
        old_devices = self.devices
        engine.release(self.alloc)
        self.fabric.reclaim(old_devices)
        alloc = engine.allocate(self.job_id, new_world, policy=self.policy,
                                kind=self.kind)
        if alloc is None:            # other tenants hold the delta: undo
            self.alloc = engine.bind(self.job_id, old_placement)
            self.devices = self.fabric.claim_exact(old_devices)
            raise RuntimeError(
                f"rescale to {new_world} not placeable on shared fabric")
        self.alloc = alloc
        new_devices = self.fabric.claim(alloc.placement)
        state, _, stats = elastic_mod.reshard_gang(state, new_devices)
        self.devices = new_devices
        self.group.resize([(self.fabric.host_of(d), d)
                           for d in new_devices])
        self.mesh = make_gang_mesh(new_devices, self.pods)
        self.fabric.tuner.on_placement_change(self.job_id, alloc.placement)
        self._log_move("rescale", stats, to=new_world)
        return state

    # ---- checkpoint / fail (fleet churn) ------------------------------------
    def _chain_reset(self) -> None:
        self._ckpt_base = None
        self._ckpt_deltas = []

    @staticmethod
    def _same_layout(a, b) -> bool:
        return _layout(a) == _layout(b)

    @_gang_span("checkpoint")
    def checkpoint(self, state: Any, step: int) -> snap_mod.Snapshot:
        """Periodic checkpoint: snapshot the gang's state to host memory
        without releasing anything — the rollback point a hard host
        failure falls back to (``fail``).

        Incremental: the first checkpoint (and every
        ``ckpt_rebase_every``-th, or any after the state layout changes
        — e.g. a serving state whose outputs grew) is a full base; the
        ticks between ship only the ``core.diffsync`` chunk diff against
        the previous checkpoint, so the recurring cost scales with the
        bytes the gang actually dirtied.  A leaf of the live ``state`` on
        the card (bit-equal to its snapshot) is compared there by the
        diff_merge kernel.  A delta tick whose diff is empty (nothing
        changed since the last checkpoint) keeps the last snapshot's host
        state and fingerprint, which are those a copy of the state would
        have: it copies and hashes nothing.  ``fail`` replays
        base+deltas and proves the chain bit-exact against the recorded
        fingerprint."""
        tel = telemetry.get()
        t_ckpt = time.perf_counter() if tel.enabled else 0.0
        prev = self.last_checkpoint
        rebase = (self._ckpt_base is None
                  or len(self._ckpt_deltas) >= self.ckpt_rebase_every - 1
                  or prev is None
                  or not self._same_layout(prev.state, state))
        if rebase:
            snap = snap_mod.take(self.job_id, step, state)
            self._ckpt_base = snap
            self._ckpt_deltas = []
            ckpt_kind, shipped = "full", snap.nbytes
        else:
            # card leaves are diffed where they lie (their dirty rows are
            # copied out); the rest against a host copy, since a host
            # row may be a view and the live leaf changes
            cpu = torch.device("cpu")
            live = [x if isinstance(x, torch.Tensor) and x.is_cuda
                    else snap_mod._copy_to(x, cpu)
                    for x in tree_leaves(state)]
            diffs = diffsync.diff_tree(prev.state,
                                       tree_unflatten(state, live),
                                       op="overwrite")
            if diffs:
                snap = snap_mod.take(self.job_id, step, state)
            else:
                snap = snap_mod.Snapshot(
                    job_id=self.job_id, step=step, state=prev.state,
                    fingerprint=prev.fingerprint, wall_time=time.time())
            self._ckpt_deltas.append(
                {"step": step, "diffs": diffs,
                 "fingerprint": snap.fingerprint})
            ckpt_kind, shipped = "delta", diffsync.diff_nbytes(diffs)
        self.last_checkpoint = snap
        self.ckpt_stats.append({"step": step, "kind": ckpt_kind,
                                "bytes": shipped,
                                "full_bytes": snap.nbytes})
        if tel.enabled:
            tel.count(f"ckpt.{ckpt_kind}")
            tel.count("ckpt.bytes_shipped", shipped)
            tel.count("ckpt.bytes_full", snap.nbytes)
            tel.gauge("ckpt.chain_len", len(self._ckpt_deltas))
            tel.span_at("ckpt.save", t_ckpt, time.perf_counter(),
                        track=f"gang:{self.job_id}", clock="wall",
                        step=step, kind=ckpt_kind, bytes=shipped,
                        full_bytes=snap.nbytes)
        self.epoch_log.append(
            {"kind": "checkpoint", "step": step,
             "fingerprint": snap.fingerprint,
             "ckpt_kind": ckpt_kind, "bytes": shipped})
        return snap

    @_gang_span("fail")
    def fail(self, dead_hosts: Sequence[int]) -> snap_mod.Snapshot:
        """A host under this gang hard-failed: the live state is gone.
        Surviving devices return to the pool (dead/draining ones are
        dropped by ``Fabric.reclaim``), and the gang becomes
        ``preempted`` with its *last checkpoint* as the resume snapshot
        — ``resume`` then restores it bit-exactly on a fresh placement.
        Engine accounting is already settled by
        ``PlacementEngine.fail_hosts``; the caller requeues the job."""
        assert self.status == "running"
        assert self.last_checkpoint is not None, \
            f"{self.job_id}: host failed before any checkpoint was taken"
        dead = {int(h) for h in dead_hosts}
        survivors = [d for d in self.devices
                     if self.fabric.host_of(d) not in dead]
        self.fabric.reclaim(survivors)
        self.devices = []
        self.alloc = None
        # recovery replays the (base, delta*) chain — every hard
        # failure proves the delta checkpoints reconstruct the rollback
        # point bit-exactly (fingerprint check against the value
        # recorded when the checkpoint was taken)
        tel = telemetry.get()
        if self._ckpt_base is not None and self._ckpt_deltas:
            t_replay = time.perf_counter()
            chain_len = len(self._ckpt_deltas)
            snap = self._ckpt_base
            for link in self._ckpt_deltas:
                snap = snap_mod.apply_delta(snap, link["diffs"],
                                            link["step"])
                if snap.fingerprint != link["fingerprint"]:
                    raise RuntimeError(
                        f"{self.job_id}: delta-chain replay diverged "
                        f"at step {link['step']}")
            self.snapshot = snap
            if tel.enabled:
                tel.count("ckpt.chain_replays")
                tel.observe("ckpt.replay_verify_s",
                            time.perf_counter() - t_replay)
                tel.gauge("ckpt.replayed_chain_len", chain_len)
        else:
            self.snapshot = self.last_checkpoint
        # the chain is consumed: the post-recovery baseline checkpoint
        # starts a fresh base (CostModel charges index 0 as full)
        self._chain_reset()
        self.status = "preempted"
        self.epoch_log.append(
            {"kind": "fail", "step": self.snapshot.step,
             "fingerprint": self.snapshot.fingerprint})
        return self.snapshot

    # ---- preempt / resume ---------------------------------------------------
    @_gang_span("preempt")
    def preempt(self, state: Any, step: int,
                release_engine: bool = True) -> snap_mod.Snapshot:
        """Checkpoint + release: snapshot the gang's state to host
        memory, free its chips for the preemptor, keep the group (queues
        and epoch survive suspension).  The caller requeues the job."""
        assert self.status == "running"
        self.snapshot = snap_mod.take(self.job_id, step, state)
        if release_engine:
            self.fabric.engine.release(self.alloc)
        self.detach()
        self.status = "preempted"
        self.epoch_log.append({"kind": "preempt", "step": step,
                               "fingerprint": self.snapshot.fingerprint})
        return self.snapshot

    @_gang_span("resume")
    def resume(self, alloc: Optional[Allocation] = None,
               verify: bool = True) -> Tuple[Any, int]:
        """Re-place and restore the preempted gang bit-exactly.

        ``alloc``: adopt an allocation the caller already made (trace
        runner); None allocates through the engine.  Returns
        (state, step); raises if no placement or the restore is not
        bit-exact (fingerprint mismatch).
        """
        assert self.status == "preempted" and self.snapshot is not None
        if alloc is None:
            alloc = self.fabric.engine.allocate(
                self.job_id, self.snapshot_world(), policy=self.policy,
                kind=self.kind)
            if alloc is None:
                raise RuntimeError("resume: gang not placeable")
        self.attach(alloc)
        state = snap_mod.restore(self.snapshot, self.mesh.device)
        restored = snap_mod.fingerprint(state) if verify else None
        if verify and restored != self.snapshot.fingerprint:
            raise RuntimeError("resume: restored state is not "
                               "bit-exact with the snapshot")
        step = self.snapshot.step
        self.epoch_log.append({"kind": "resume", "step": step,
                               "fingerprint": self.snapshot.fingerprint,
                               "restored_fingerprint": restored})
        self.snapshot = None
        # every (re)start segment opens with a fresh base checkpoint —
        # mirrors the simulator's per-RunningJob ckpt_count reset
        self._chain_reset()
        return state, step

    def snapshot_world(self) -> int:
        """World size to restore a preempted gang at (its group size)."""
        return self.group.size if self.group is not None else 0

    # ---- release -----------------------------------------------------------
    @_gang_span("release")
    def release(self) -> None:
        """Return the gang's chips to the shared pool."""
        if self.status == "running":
            self.fabric.engine.release(self.alloc)
            self.detach()
        self.status = "released"
        self.fabric.tuner.forget(self.job_id)
        self.fabric.gangs.pop(self.job_id, None)


class Fabric:
    """The shared device pool + placement engine all gangs run on.

    ``devices``: the pool (default: ``n_virtual`` virtual devices of the
    torch ``device``, CUDA unless the caller asks for the CPU; raises on
    a machine without a GPU otherwise); hosts are consecutive runs of
    ``chips_per_host`` devices, and the ragged last host is carried as a
    reduced per-host capacity in the engine (no phantom pad job) — both
    derived by the shared ``placement.derive_capacities`` via
    ``PlacementEngine.for_chips``.
    A mixed-generation device pool (differing ``device_kind``) is
    auto-detected into per-host ``speeds``; pass ``speeds`` explicitly
    to model a mixed fleet on uniform local devices (e.g.
    ``simulator.hetero_speeds``).
    ``shard_hosts`` builds the fabric over a decentralised
    ``ShardedPlacementEngine`` (host groups of that size) instead of the
    centralised engine — every gang decision then consults the shard
    summary index first; with one shard covering the fleet the two are
    decision-for-decision identical.
    """

    def __init__(self, devices: Optional[Sequence[Any]] = None,
                 chips_per_host: int = 4,
                 policy: Union[str, PlacementPolicy] = "binpack",
                 preempt: Optional[PreemptPolicy] = None,
                 speeds: Optional[Sequence[float]] = None,
                 cost_model: Optional[CostModel] = None,
                 shard_hosts: Union[int, str, None] = None,
                 steal_budget: int = 0,
                 spares: Optional[Sequence[Any]] = None,
                 tuner: Optional[coll.CollectiveTuner] = None,
                 n_virtual: int = 8, device="cuda"):
        self.devices = list(devices if devices is not None
                            else virtual_devices(n_virtual, device))
        assert self.devices, "empty fabric"
        self.chips_per_host = chips_per_host
        # topology-tuned collective dispatch (DESIGN.md §11): gangs
        # re-derive their entries on every placement change and ask it
        # for the sync schedule via GangHandle.best_sync_mode
        self.tuner = tuner or coll.CollectiveTuner(
            link=(cost_model.link if cost_model is not None else None))
        self._dev_index = {d: i for i, d in enumerate(self.devices)}
        if speeds is None:
            speeds = infer_host_speeds(self.devices, chips_per_host)
        if shard_hosts is None:
            self.engine = PlacementEngine.for_chips(
                len(self.devices), chips_per_host, policy=policy,
                speeds=speeds, cost_model=cost_model)
        else:
            self.engine = ShardedPlacementEngine.for_chips(
                len(self.devices), chips_per_host, policy=policy,
                speeds=speeds, cost_model=cost_model,
                hosts_per_shard=shard_hosts, steal_budget=steal_budget)
        self.preempt = preempt or PreemptPolicy()
        self.gangs: Dict[str, GangHandle] = {}
        # device -> host map (explicit: joined hosts and ragged hosts
        # break the old index//chips_per_host arithmetic) and per-host
        # free pools, both laid out by the engine's capacity runs
        self._dev_host: Dict[Any, int] = {}
        self._free: List[List[Any]] = []
        i = 0
        for h, cap in enumerate(self.engine.capacities):
            group = self.devices[i:i + int(cap)]
            i += int(cap)
            for d in group:
                self._dev_host[d] = h
            self._free.append(group)
        # fleet churn: staged spare devices (future joins draw from
        # them) and hosts whose devices must never re-enter the pool
        self.spares: List[Any] = list(spares or [])
        self._draining_hosts: set = set()
        self._retired_hosts: set = set()

    # ---- device pool -------------------------------------------------------
    def host_of(self, device: Any) -> int:
        return self._dev_host[device]

    def claim(self, placement: Sequence[Tuple[int, int]]) -> List[Any]:
        """Take the lowest-indexed free devices matching an engine
        placement (deterministic, so simulation and execution agree)."""
        out: List[Any] = []
        for h, c in placement:
            pool = self._free[h]
            assert len(pool) >= c, \
                f"host {h}: {c} chips claimed, {len(pool)} free"
            out.extend(pool[:c])
            self._free[h] = pool[c:]
        return out

    def claim_exact(self, devices: Sequence[Any]) -> List[Any]:
        """Take specific devices out of the free pool (bind/undo paths)."""
        for d in devices:
            self._free[self.host_of(d)].remove(d)
        return list(devices)

    def reclaim(self, devices: Sequence[Any]) -> None:
        doomed = self._draining_hosts | self._retired_hosts
        for d in devices:
            h = self.host_of(d)
            if h in doomed:
                continue              # the provider has these back
            self._free[h].append(d)
        for pool in self._free:
            pool.sort(key=self._dev_index.__getitem__)

    def idle_chips(self) -> int:
        return self.engine.idle_chips()

    # ---- fleet churn (pool side; engine accounting via core.fleet) ---------
    def take_spares(self, n: int) -> List[Any]:
        """Draw ``n`` staged spare devices for a join event."""
        assert len(self.spares) >= n, \
            f"join needs {n} spare devices, {len(self.spares)} staged"
        taken, self.spares = self.spares[:n], self.spares[n:]
        return taken

    def _pool_add_hosts(self, devices: Sequence[Any],
                        capacities: Sequence[int]) -> None:
        """Append joined devices as new host pools (engine indices were
        already assigned by ``PlacementEngine.add_hosts``)."""
        assert sum(capacities) == len(devices)
        base = len(self.devices)
        for j, d in enumerate(devices):
            self._dev_index[d] = base + j
        self.devices.extend(devices)
        i = 0
        for cap in capacities:
            h = len(self._free)
            group = list(devices[i:i + int(cap)])
            i += int(cap)
            for d in group:
                self._dev_host[d] = h
            self._free.append(group)
        assert len(self._free) == self.engine.hosts, \
            "pool and engine host maps diverged"

    def join_hosts(self, devices: Sequence[Any]) -> List[int]:
        """Lease new hosts into a live fabric (direct, non-trace API):
        engine capacity + device pool in one move.  Devices group into
        ``chips_per_host`` runs (ragged last host allowed).  Joiners'
        generation factors are inferred like the constructor's
        ``infer_host_speeds``: an older-generation host joining a
        uniform fleet re-opens the heterogeneous cost-model path at its
        speed relative to the incumbent generation."""
        caps = derive_capacities(len(devices), self.chips_per_host)
        kinds = [str(getattr(d, "device_kind", "")) for d in devices]
        new_speeds, i = [], 0
        for cap in caps:
            new_speeds.append(float(np.mean(
                [DEVICE_KIND_SPEEDS.get(k, 1.0)
                 for k in kinds[i:i + cap]])))
            i += cap
        if self.engine.speeds is not None:
            # engine already carries absolute generation factors
            speeds: Optional[List[float]] = new_speeds
        else:
            # uniform speedless fleet runs at relative 1.0; scale the
            # joiners against the incumbent generation and only
            # materialise speeds when they actually differ
            base_kinds = {str(getattr(d, "device_kind", ""))
                          for d in self.devices}
            base = (DEVICE_KIND_SPEEDS.get(next(iter(base_kinds)), 1.0)
                    if len(base_kinds) == 1 else 1.0)
            rel = [s / base for s in new_speeds]
            speeds = (None if all(abs(r - 1.0) < 1e-9 for r in rel)
                      else rel)
        new_idx = self.engine.add_hosts(caps, speeds=speeds)
        self._pool_add_hosts(list(devices), caps)
        return new_idx

    def mark_draining(self, hosts: Sequence[int]) -> None:
        """Pool side of a lease reclaim: free devices on the hosts go
        back to the provider now; gang devices follow as they leave
        (``reclaim`` drops them)."""
        for h in hosts:
            h = int(h)
            self._free[h] = []
            self._draining_hosts.add(h)

    def fail_hosts_pool(self, hosts: Sequence[int]) -> None:
        """Pool side of a host failure/retirement: the hosts' devices
        are gone for good."""
        for h in hosts:
            h = int(h)
            self._free[h] = []
            self._retired_hosts.add(h)
            self._draining_hosts.discard(h)

    def fail_hosts(self, hosts: Sequence[int]) -> List[str]:
        """Hard host failure against live gangs (direct, non-trace API):
        engine accounting drops the dead chips, each affected gang falls
        back to its last checkpoint snapshot (status ``preempted``).
        Returns the failed job_ids; the caller resumes each via
        ``GangHandle.resume`` (bit-exact, fingerprint-verified)."""
        failed = self.engine.fail_hosts(hosts)
        self.fail_hosts_pool(hosts)
        dead = {int(h) for h in hosts}
        for jid in failed:
            handle = self.gangs.get(jid)
            if handle is not None and handle.status == "running":
                handle.fail(dead)
        return failed

    def reclaim_hosts(self, hosts: Sequence[int]
                      ) -> Tuple[List[Tuple[str, Any]], List[str]]:
        """Begin a live lease reclaim (direct, non-trace API): the hosts
        drain, and the evacuation planner proposes moves for affected
        gangs.  Returns ``(plans, stranded)``; the caller — who owns
        each gang's state pytree — applies every plan with
        ``GangHandle.evacuate(state, placement)`` and, when the drain
        deadline passes, retires the hosts with ``fail_hosts``."""
        self.engine.drain_hosts(hosts)
        self.mark_draining(hosts)
        kinds = {jid: g.kind for jid, g in self.gangs.items()
                 if g.kind is not None}
        return self.engine.evacuation_plan(hosts, kinds=kinds)

    # ---- gang lifecycle ----------------------------------------------------
    def allocate(self, job_id: str, n: int, priority: int = 0,
                 pods: int = 1,
                 policy: Union[str, PlacementPolicy, None] = None,
                 kind: Optional[str] = None) -> Optional[GangHandle]:
        """Policy-driven gang allocation; None when it does not fit.
        ``kind`` (trace job kind) keys the CostModel's per-kind beta for
        this and every later placement decision of the gang."""
        alloc = self.engine.allocate(job_id, n, policy=policy, kind=kind)
        if alloc is None:
            return None
        handle = GangHandle(self, job_id, priority=priority, pods=pods,
                            policy=policy, kind=kind)
        handle.attach(alloc)
        self.gangs[job_id] = handle
        return handle

    def bind(self, job_id: str, devices: Sequence[Any], priority: int = 0,
             pods: int = 1,
             policy: Union[str, PlacementPolicy, None] = None,
             kind: Optional[str] = None) -> GangHandle:
        """Adopt an externally-chosen device list (a launch-time gang),
        preserving its rank order."""
        counts: Dict[int, int] = {}
        for d in devices:
            counts[self.host_of(d)] = counts.get(self.host_of(d), 0) + 1
        alloc = self.engine.bind(job_id, sorted(counts.items()))
        handle = GangHandle(self, job_id, priority=priority, pods=pods,
                            policy=policy, kind=kind)
        handle.attach(alloc, devices=self.claim_exact(devices))
        self.gangs[job_id] = handle
        return handle

    def adopt(self, alloc: Allocation, priority: int = 0, pods: int = 1,
              handle: Optional[GangHandle] = None,
              kind: Optional[str] = None) -> GangHandle:
        """Build/re-attach a handle for an allocation the engine already
        holds (the trace runner's event loop owns engine accounting)."""
        if handle is None:
            handle = GangHandle(self, alloc.job_id, priority=priority,
                                pods=pods, kind=kind)
        handle.attach(alloc)
        self.gangs[alloc.job_id] = handle
        return handle

    def priorities(self) -> Dict[str, int]:
        return {jid: h.priority for jid, h in self.gangs.items()}

    def preemption_plan(self, n: int, priority: int,
                        kind: Optional[str] = None) -> Optional[List[str]]:
        """Victims (lower-priority gangs) to evict so an ``n``-chip gang
        at ``priority`` fits — the live counterpart of the simulator's
        preemption step; the caller checkpoints + requeues them.
        ``kind`` feeds the arrival's per-kind beta into the fit probe."""
        return self.engine.preemption_plan(n, priority, self.priorities(),
                                           preempt=self.preempt, kind=kind)

    def grow_with_drain(self, handle: GangHandle, state: Any,
                        new_world: int,
                        donors: Sequence[Tuple[GangHandle, Any, int]] = ()
                        ) -> Tuple[Any, Dict[str, Any]]:
        """Grow a latency-sensitive gang (a serve gang under SLO
        pressure), *draining* elastic donors instead of killing anyone.

        Tries the plain ``rescale`` first; when the shared pool can't
        fit it, the largest donor gang halves (down to its floor) via
        its own ``rescale`` — a graceful shrink at the donor's control
        point that keeps every step of progress, unlike a preemption
        rollback — and the grow retries.  ``donors`` is
        ``[(handle, state, min_world), ...]`` for tenants whose state
        the caller owns (the autoscaler's training neighbours).

        Returns ``(state, {donor_job_id: new_donor_state})`` — donor
        states that were resharded.  Raises RuntimeError when the grow
        still doesn't fit after every donor is at its floor."""
        donor_states: Dict[str, Any] = {}
        pool = [[d, s, int(m)] for d, s, m in donors]
        while True:
            try:
                state = handle.rescale(state, new_world)
                return state, donor_states
            except RuntimeError:
                givers = [e for e in pool
                          if e[0].n // 2 >= e[2] and e[0].n > 1]
                if not givers:
                    raise
                entry = max(givers, key=lambda e: e[0].n)
                d_handle, d_state, d_min = entry
                entry[1] = d_handle.rescale(d_state,
                                            max(d_min, d_handle.n // 2))
                donor_states[d_handle.job_id] = entry[1]

    # ---- trace execution ---------------------------------------------------
    def run_trace(self, jobs: Sequence[Job],
                  workload_factory: Callable[[Job], GangWorkload],
                  policy: Union[str, PlacementPolicy, None] = None,
                  preempt: Union[bool, PreemptPolicy] = True,
                  migrate: bool = False, backfill: bool = False,
                  fleet_events: Optional[Sequence[Any]] = None,
                  checkpoint_interval: Optional[float] = None,
                  shrink_recovery: bool = False,
                  adapt_cadence: bool = False
                  ) -> "TraceExecution":
        """Execute an arrival-time trace — Poisson arrivals, priority
        classes, preemption — against real concurrent gangs on this
        fabric.  Scheduling runs on the simulator's virtual clock; gang
        steps are real torch computations.  ``fleet_events`` interleaves
        fleet churn (``core.fleet``): joins draw staged ``spares``,
        reclaims drain and evacuate live gangs, hard failures roll gangs
        back to their last real snapshot; ``checkpoint_interval`` sets
        the periodic live-checkpoint cadence.  ``shrink_recovery`` turns
        on shrink-before-rollback (stranded gangs reshard onto
        surviving capacity instead of rolling back; DESIGN.md §13) and
        ``adapt_cadence`` re-derives the Young/Daly interval from
        measured delta-checkpoint bytes after each rebase window (live
        only — it breaks Action-log parity with ``predict_trace``).
        See ``LiveTraceRunner``."""
        assert not self.gangs, "run_trace requires an idle fabric"
        runner = LiveTraceRunner(self, workload_factory,
                                 policy=policy or self.engine.default_policy,
                                 preempt=preempt, migrate=migrate,
                                 backfill=backfill,
                                 checkpoint_interval=checkpoint_interval,
                                 shrink_recovery=shrink_recovery,
                                 adapt_cadence=adapt_cadence)
        t0 = time.time()
        try:
            result = runner.run(list(jobs), fleet_events=fleet_events)
        finally:
            # hand the steal-budget lifecycle back to direct callers
            # (the runner's event loop owned it during the trace)
            self.engine.external_budget_reset = False
        tel = telemetry.get()
        if tel.enabled:
            # close item 2's loop: measured per-(host-kind, job-kind)
            # step times land in the cost model's calibration store
            tel.feed_cost_model(self.engine.cost_model)
        return TraceExecution(result=result, live=dict(runner.records),
                              wall_s=time.time() - t0)

    def predict_trace(self, jobs: Sequence[Job],
                      policy: Union[str, PlacementPolicy, None] = None,
                      preempt: Union[bool, PreemptPolicy] = True,
                      migrate: bool = False, backfill: bool = False,
                      fleet_events: Optional[Sequence[Any]] = None,
                      checkpoint_interval: Optional[float] = None,
                      shrink_recovery: bool = False
                      ) -> TraceResult:
        """Pure-simulation prediction for the same trace on a fabric of
        this shape (same hosts, capacities, per-host speeds, cost model
        — risk term and all, via ``clone_empty`` copying the lease
        metadata — policy, and centralised-vs-sharded engine
        architecture) — what ``run_trace`` should reproduce,
        placement-for-placement, churn schedule, shrink recoveries and
        all."""
        pol = policy or self.engine.default_policy
        engine = self.engine.clone_empty()
        sim = Simulator(engine.hosts, self.chips_per_host, "granular",
                        migrate=migrate, policy=pol, backfill=backfill,
                        preempt=preempt, engine=engine,
                        checkpoint_interval=checkpoint_interval,
                        shrink_recovery=shrink_recovery)
        return sim.run(list(jobs), fleet_events=fleet_events)


@dataclasses.dataclass
class TraceExecution:
    """Result of a live ``Fabric.run_trace``: the (virtual-time) trace
    result plus the per-job live execution log."""
    result: TraceResult
    live: Dict[str, Dict[str, Any]]
    wall_s: float = 0.0

    def job_makespans(self, jobs: Sequence[Job]) -> Dict[str, float]:
        return self.result.makespans(jobs)


class LiveTraceRunner(Simulator):
    """Trace-driven live execution (the simulate→execute bridge).

    Inherits the discrete-event loop — queueing discipline, priorities,
    Poisson arrivals, placement, preemption — and overrides the event
    hooks to drive *real* gangs on a shared ``Fabric``: virtual time
    decides *when/where*, the hooks execute *actual* train/serve steps on
    the allocated devices.  Because the loop and the placement engine are
    shared with the pure simulator, the live completion order matches
    ``Fabric.predict_trace`` for the same trace and policy.

    Interleaving: every event advances each running gang by one real
    step, so concurrent gangs genuinely alternate on the fabric; a
    finishing gang runs its remaining steps at its FINISH event; a
    preempted gang is checkpointed (snapshot) mid-run and later resumes
    bit-exactly on whatever placement the engine grants.
    """

    def __init__(self, fabric: Fabric,
                 workload_factory: Callable[[Job], GangWorkload],
                 policy: Union[str, PlacementPolicy] = "binpack",
                 preempt: Union[bool, PreemptPolicy] = True,
                 migrate: bool = False, backfill: bool = False,
                 checkpoint_interval: Optional[float] = None,
                 shrink_recovery: bool = False,
                 adapt_cadence: bool = False):
        super().__init__(fabric.engine.hosts, fabric.chips_per_host,
                         "granular", migrate=migrate, policy=policy,
                         backfill=backfill, preempt=preempt,
                         engine=fabric.engine,
                         checkpoint_interval=checkpoint_interval,
                         shrink_recovery=shrink_recovery)
        self.fabric = fabric
        self.factory = workload_factory
        self.workloads: Dict[str, GangWorkload] = {}
        self.handles: Dict[str, GangHandle] = {}
        self.records: Dict[str, Dict[str, Any]] = {}
        # set per run(): with churn possible, every gang start takes a
        # baseline snapshot so a hard failure always has a rollback point
        self._churn = checkpoint_interval is not None
        # adaptive Young/Daly cadence (opt-in; breaks Action-log parity
        # with predict_trace, which never sees the measured bytes):
        # after each rebase window the interval is re-derived from the
        # observed delta fraction — tau* scales as sqrt(delta), so
        # tau = tau0 * sqrt(eff_observed / eff_configured)
        self.adapt_cadence = adapt_cadence
        self._tau0 = checkpoint_interval

    def run(self, jobs, fleet_events=None):
        self._churn = bool(fleet_events) \
            or self.checkpoint_interval is not None
        return super().run(jobs, fleet_events=fleet_events)

    def _record(self, job_id: str) -> Dict[str, Any]:
        return self.records.setdefault(
            job_id, {"steps": 0, "preemptions": 0, "resumes_verified": 0,
                     "metrics": {}, "epochs": []})

    def _record_move(self, job_id: str, kind: str,
                     stats: Dict[str, float]) -> None:
        """Log one live state move (seconds, bytes) in the job's record."""
        self._record(job_id).setdefault("moves", []).append(
            {"kind": kind, **stats})

    def _step_gang(self, job_id: str) -> None:
        wl = self.workloads[job_id]
        if wl.done:
            return
        handle = self.handles[job_id]
        tel = telemetry.get()
        if tel.enabled:
            t0 = time.perf_counter()
            metrics = wl.run_step(handle)
            dt = time.perf_counter() - t0
            hk = str(getattr(handle.devices[0], "device_kind", "cpu")
                     if handle.devices else "cpu")
            tel.step_time(hk, handle.kind or "train", dt)
            tel.count("gang.steps")
        else:
            metrics = wl.run_step(handle)
        rec = self._record(job_id)
        rec["steps"] = wl.steps_done
        rec["metrics"] = metrics

    # ---- hooks -------------------------------------------------------------
    def _on_start(self, rj, resumed: bool) -> None:
        job = rj.job
        wl = self.workloads.get(job.job_id)
        if wl is None:
            wl = self.workloads[job.job_id] = self.factory(job)
        handle = self.handles.get(job.job_id)
        if resumed:
            assert handle is not None and handle.status == "preempted"
            state, step = handle.resume(alloc=rj.alloc)  # bit-exact restore
            self.fabric.gangs[job.job_id] = handle
            wl.state = state
            # a recovery resume rolls the data cursor back to the
            # checkpointed step (a preemption resume restored the
            # suspension step: a no-op there)
            wl.steps_done = step
            wl.bind(handle)
            self._record(job.job_id)["resumes_verified"] += 1
        else:
            handle = self.fabric.adopt(rj.alloc, priority=job.priority,
                                       pods=wl.pods, handle=handle,
                                       kind=job.kind)
            self.handles[job.job_id] = handle
            wl.bind(handle)
            if wl.state is None:
                wl.init_state(handle)
        self._record(job.job_id)["workload"] = type(wl).__name__
        if self._churn:
            # baseline rollback point: matches the simulator's
            # ckpt_progress = progress-at-start bookkeeping (index 0 of
            # the delta chain — always a full base)
            handle.ckpt_rebase_every = self.model.ckpt_rebase_every
            handle.checkpoint(wl.state, wl.steps_done)
        self._step_gang(job.job_id)    # gangs make real progress at start

    def _on_advance(self, now: float) -> None:
        # one real step per running gang per event: concurrent gangs
        # interleave on the fabric exactly as wall-clock sharing would
        for job_id, handle in self.handles.items():
            if handle.status == "running":
                self._step_gang(job_id)

    def _on_preempt(self, rj) -> None:
        job_id = rj.job.job_id
        handle = self.handles[job_id]
        wl = self.workloads[job_id]
        # engine accounting already released by the event loop
        handle.preempt(wl.state, wl.steps_done, release_engine=False)
        self.fabric.gangs.pop(job_id, None)
        wl.state = None               # lives in the snapshot until resume
        rec = self._record(job_id)
        rec["preemptions"] += 1
        rec["epochs"].append(handle.group.epoch)

    def _on_migrate(self, rj) -> None:
        job_id = rj.job.job_id
        handle = self.handles[job_id]
        wl = self.workloads[job_id]
        # the loop already applied the engine migration; move the gang:
        # copy live state onto the new devices, then re-attach (the
        # in-place readdress keeps queues + epoch)
        self.fabric.reclaim(handle.devices)
        new_devices = self.fabric.claim(rj.alloc.placement)
        wl.state, _, stats = elastic_mod.reshard_gang(wl.state, new_devices)
        handle.attach(rj.alloc, devices=new_devices)
        wl.bind(handle)
        self._record_move(job_id, "migrate", stats)

    def _on_finish(self, rj) -> None:
        job_id = rj.job.job_id
        handle = self.handles[job_id]
        while not self.workloads[job_id].done:
            self._step_gang(job_id)   # drain the gang's remaining steps
        handle.detach()               # loop releases engine accounting
        handle.status = "released"
        self.fabric.gangs.pop(job_id, None)
        rec = self._record(job_id)
        rec["final_metrics"] = rec.pop("metrics", {})

    # ---- fleet-churn hooks (core.fleet events, live) -----------------------
    def _on_join(self, ev, new_hosts) -> None:
        # engine capacity is already in (the loop's FleetController);
        # back the new hosts with staged spare devices
        caps = [int(c) for c in ev.capacities]
        devices = self.fabric.take_spares(sum(caps))
        self.fabric._pool_add_hosts(devices, caps)

    def _on_drain(self, ev) -> None:
        self.fabric.mark_draining(ev.hosts)

    def _on_hosts_down(self, hosts) -> None:
        self.fabric.fail_hosts_pool(hosts)

    def _on_checkpoint(self, rj) -> None:
        job_id = rj.job.job_id
        wl = self.workloads[job_id]
        handle = self.handles[job_id]
        snap = handle.checkpoint(wl.state, wl.steps_done)
        stat = handle.ckpt_stats[-1]
        rec = self._record(job_id)
        rec["checkpoints"] = rec.get("checkpoints", 0) + 1
        rec["last_ckpt_fingerprint"] = snap.fingerprint
        if stat["kind"] == "delta":
            rec["delta_checkpoints"] = rec.get("delta_checkpoints", 0) + 1
        rec["ckpt_bytes"] = rec.get("ckpt_bytes", 0) + stat["bytes"]
        rec["ckpt_full_bytes"] = (rec.get("ckpt_full_bytes", 0)
                                  + stat["full_bytes"])
        # measured bytes feed calibration stats only — the trace keeps
        # charging the configured fraction so Action logs stay
        # identical to predict_trace
        self.model.observe_checkpoint(stat["bytes"], stat["full_bytes"])
        if self.adapt_cadence and self.checkpoint_interval is not None \
                and len(self.model.ckpt_observed) \
                % self.model.ckpt_rebase_every == 0:
            # rebase window closed: fold the *measured* delta fraction
            # into the Young/Daly interval (tau* ∝ sqrt(delta))
            frac = self.model.observed_delta_fraction()
            eff0 = self.model.effective_checkpoint_cost_s()
            if frac is not None and eff0 > 0:
                eff = self.model.effective_checkpoint_cost_s(
                    fraction=frac)
                self.checkpoint_interval = float(
                    self._tau0 * np.sqrt(eff / eff0))
                rec["adapted_interval_s"] = self.checkpoint_interval

    def _on_shrink(self, rj, survivors) -> None:
        # shrink-before-rollback (or a regrow back to full width),
        # live: the event loop already settled engine accounting
        # (apply_migration mid-drain, bind after a hard fail) and
        # rj.alloc carries the new placement.  State is replicated
        # across the gang, so any surviving replica reshards it onto
        # the new devices with nothing lost; dead and draining devices
        # are dropped by the pool's reclaim.
        job_id = rj.job.job_id
        handle = self.handles[job_id]
        wl = self.workloads[job_id]
        old_width = len(handle.devices)
        self.fabric.reclaim(handle.devices)
        new_devices = self.fabric.claim(rj.alloc.placement)
        wl.state, _, stats = elastic_mod.reshard_gang(wl.state, new_devices)
        handle.attach(rj.alloc, devices=new_devices)
        self.fabric.gangs[job_id] = handle
        wl.bind(handle)
        rec = self._record(job_id)
        key = "shrinks" if len(new_devices) < old_width else "regrows"
        rec[key] = rec.get(key, 0) + 1
        self._record_move(job_id, key[:-1], stats)
        rec["epochs"].append(handle.group.epoch)

    def _on_fail(self, rj, hosts) -> None:
        # the gang's host died: live state is gone; fall back to the
        # last real snapshot (engine accounting already settled by
        # fail_hosts; the loop requeues the job and the resumed start
        # restores bit-exactly via handle.resume)
        job_id = rj.job.job_id
        handle = self.handles[job_id]
        wl = self.workloads[job_id]
        handle.fail(hosts)
        self.fabric.gangs.pop(job_id, None)
        wl.state = None               # lives in the snapshot until resume
        wl.steps_done = handle.snapshot.step
        rec = self._record(job_id)
        rec["failures"] = rec.get("failures", 0) + 1
