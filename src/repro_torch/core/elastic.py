"""Elastic scaling of the data-parallel world at control points (PyTorch
port of ``repro.core.elastic``).

A training job grows or shrinks its data-parallel gang while keeping the
*global* batch size and the loss trajectory unchanged:

* params/optimizer state are placement-independent: the gang holds one
  replica, which moves onto the new virtual devices;
* the deterministic data pipeline is keyed by (seed, step), so per-rank
  batch slices re-partition cleanly at any step boundary;
* growth uses the scheduler to carve a larger sub-mesh; shrink releases
  chips back to the shared pool (the provider-utilisation story of §2.1).

``shrink_worlds`` and ``ElasticPolicy`` are the JAX module's, line for
line; ``reshard_gang`` copies the state onto the new device set.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import diffsync, migration
from repro_torch.core.devices import GangMesh, make_gang_mesh
from repro_torch.core.placement import PlacementEngine


def make_dp_mesh(devices: Sequence[Any]) -> GangMesh:
    """1-D data-parallel mesh over an explicit device list (a gang)."""
    return make_gang_mesh(devices, 1)


def replicated_shardings(state, mesh: GangMesh) -> torch.device:
    """Where a replicated gang's ``state`` goes on ``mesh``: the mesh's
    torch device, the destination ``migration.migrate_live(state, dst)``
    and ``migration.migrate_via_snapshot(job, step, state, dst)`` take.
    The JAX package returns a tree of ``NamedSharding(mesh, P())``, one
    per leaf of ``state``, which ``device_put`` reads; the port runs a
    gang's virtual ranks on one torch device and keeps one copy of a
    replicated state, so the whole tree has that one destination."""
    return mesh.device


def reshard_gang(state, new_devices: Sequence[Any]
                 ) -> Tuple[Any, GangMesh, Dict[str, float]]:
    """Re-factorise a DP gang onto a new device set (grow or shrink).

    Returns (new_state, new_mesh, stats).  State is replicated across the
    gang, so this is a pure placement change, bit-exact by construction.
    The port's virtual devices of one card share a torch device, and a
    move that copied nothing would report nothing: the state is always
    copied (``migration.migrate_live``), and the caller frees the old copy
    by dropping it.  So the gang briefly holds two copies.  ``stats``:
    the seconds the copy took (the device synchronised) and its bytes."""
    mesh = make_dp_mesh(new_devices)
    t0 = time.perf_counter()
    new_state = migration.migrate_live(state, mesh.device)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return new_state, mesh, {"seconds": time.perf_counter() - t0,
                             "bytes": diffsync.tree_nbytes(new_state)}


def shrink_worlds(n: int, floor: Optional[int] = None) -> List[int]:
    """Candidate world sizes for shrink-before-rollback, largest first:
    the gang's full width ``n`` (a refit onto surviving capacity keeps
    everything), then each power of two below it down to ``floor``
    (powers of two keep the global batch dividing evenly, the same
    snapping ``ElasticPolicy`` uses).  ``floor`` defaults to
    ``max(1, n // 4)``: shrinking more than 4x runs so slowly that a
    checkpoint rollback + full-width requeue wins once capacity
    returns."""
    if floor is None:
        floor = max(1, n // 4)
    worlds = [n]
    p = 1
    while p * 2 < n:
        p *= 2
    while p >= max(1, floor) and p < n:
        worlds.append(p)
        p //= 2
    return worlds


@dataclasses.dataclass
class ElasticPolicy:
    """Decides the DP world size from the cluster's free-chip signal.

    ``target_free``: leave this many chips for other tenants (the paper's
    shared-cluster economics); world size snaps to powers of two so the
    global batch divides evenly.

    The decision goes through the shared ``PlacementEngine`` — the same
    free-chip accounting the simulator and scheduler use: the budget
    comes from ``engine.idle_chips()``, and a grow is validated with a
    reservation probe.  The shipped greedy policies can always fragment
    a gang into any free chips, so the probe only rejects under future
    contiguity-constrained policies; it is released before returning,
    so a caller that needs to *hold* the chips across a multi-step
    rescale should keep its own ``engine.reserve`` open until commit.
    """
    min_world: int = 1
    max_world: int = 64
    target_free: int = 0

    def decide(self, world: int, engine: PlacementEngine,
               kind: Optional[str] = None) -> Optional[int]:
        """``kind`` is the tenant's job kind: the grow probe runs the
        engine's placement policy under the same per-kind beta the
        simulator and migration planner use (``engine.cost_model``), so
        an elastic grow lands exactly where a trace placement would."""
        budget = world + engine.idle_chips() - self.target_free
        new = self.min_world
        while new * 2 <= min(budget, self.max_world):
            new *= 2
        if new == world:
            return None
        if new > world:
            res = engine.reserve(new - world, kind=kind)
            if res is None:                 # gang not carveable right now
                return None
            engine.cancel(res)
        return new

    def decide_scaled(self, world: int, engine: PlacementEngine,
                      factor: float,
                      kind: Optional[str] = None) -> Optional[int]:
        """Directional variant for feedback controllers (the serve
        autoscaler): ask for ``world * factor`` chips instead of the
        whole free budget.  ``factor`` > 1 grows toward the SLO (capped
        by the free-chip budget and validated with a reserve probe like
        ``decide``), < 1 drains capacity back to the pool.  The result
        snaps to a power of two within [min_world, max_world]; returns
        None when no change is possible right now."""
        def p2floor(x: float) -> int:
            n = self.min_world
            while n * 2 <= x:
                n *= 2
            return n

        want = max(float(self.min_world),
                   min(float(self.max_world), world * factor))
        new = p2floor(want)
        if new > world:
            budget = world + engine.idle_chips() - self.target_free
            new = min(new, p2floor(budget))
        if new == world:
            return None
        if new > world:
            res = engine.reserve(new - world, kind=kind)
            if res is None:
                return None
            engine.cancel(res)
        return new
