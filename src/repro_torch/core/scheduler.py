"""Cluster scheduler facade: chip-granular gang allocation (paper §3.4).

The paper's headline mechanism is scheduling threads/processes at vCPU
granularity onto shared VMs instead of dedicating whole VMs.  The TPU
adaptation schedules *Granules* (one per chip) onto shared hosts.

All placement mechanics live in ``core.placement``: ``PlacementEngine``
owns the free-chip accounting, gang allocation, reservations, and
barrier-point migration planning, and ``PlacementPolicy`` implementations
(binpack / spread / locality / fixed-slice) decide where a gang lands.
``ClusterState`` survives as the thin facade the rest of the repo (and
the tests) already speak:

* ``alloc_granular`` — policy-driven chip-granular gang allocation
  (default: Faabric's binpack).
* ``alloc_slices``  — the fixed-slice baselines of §6.2 (the "k
  containers per VM" baselines); a job takes whole slices.
* ``migration_plan`` — at barrier control points, find fragmented gangs
  that now fit on fewer hosts and emit Granule moves (paper §3.3, Fig 8).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

from repro_torch.core.placement import (Allocation, FixedSlicePolicy,
                                  PlacementEngine, PlacementPolicy,
                                  ShardedPlacementEngine)

__all__ = ["Allocation", "ClusterState"]


class ClusterState:
    """Free-chip accounting for a cluster of hosts — a facade over
    ``PlacementEngine`` keeping the original call signatures.
    ``capacities``/``speeds`` open the heterogeneous-fleet path (ragged
    hosts, mixed generations) without changing any caller;
    ``shard_hosts`` runs the facade over the decentralised
    ``ShardedPlacementEngine`` (host groups of that size) — same
    signatures, O(shard) decisions."""

    def __init__(self, hosts: int, chips_per_host: int,
                 capacities: Optional[Sequence[int]] = None,
                 speeds: Optional[Sequence[float]] = None,
                 shard_hosts: Optional[int] = None):
        if shard_hosts is None:
            self.engine = PlacementEngine(hosts, chips_per_host,
                                          capacities=capacities,
                                          speeds=speeds)
        else:
            self.engine = ShardedPlacementEngine(
                hosts, chips_per_host, hosts_per_shard=shard_hosts,
                capacities=capacities, speeds=speeds)
        self.hosts = hosts
        self.chips_per_host = chips_per_host

    # ---- capacity ----------------------------------------------------------
    @property
    def free(self):
        return self.engine.free

    @property
    def capacities(self):
        return self.engine.capacities

    @property
    def speeds(self):
        return self.engine.speeds

    @property
    def jobs_on_host(self):
        return self.engine.jobs_on_host

    @property
    def total_chips(self) -> int:
        return self.engine.total_chips

    def idle_chips(self) -> int:
        return self.engine.idle_chips()

    def idle_fraction(self) -> float:
        return self.engine.idle_fraction()

    def idle_throughput(self) -> float:
        return self.engine.idle_throughput()

    # ---- allocation ----------------------------------------------------------
    def alloc_granular(self, job_id: str, n: int,
                       policy: Union[str, PlacementPolicy] = "binpack",
                       kind: Optional[str] = None) -> Optional[Allocation]:
        """Chip-granular gang allocation under a named placement policy
        (binpack / spread / locality) or a ``PlacementPolicy`` instance;
        ``kind`` routes the job's per-kind beta into model-scoring
        policies."""
        return self.engine.allocate(job_id, n, policy=policy, kind=kind)

    def alloc_slices(self, job_id: str, n_chips: int,
                     slice_size: int) -> Optional[Allocation]:
        """Whole-slice allocation: ceil(n/slice) slices, each on one host."""
        return self.engine.allocate(job_id, n_chips,
                                    policy=FixedSlicePolicy(slice_size))

    # ---- free ----------------------------------------------------------------
    def release(self, alloc: Allocation) -> None:
        self.engine.release(alloc)

    # ---- migration (defragmentation at barrier points) ------------------------
    def migration_plan(self, allocs: Sequence[Allocation],
                       kinds: Optional[dict] = None,
                       remaining: Optional[dict] = None
                       ) -> List[Tuple[str, List[Tuple[int, int]]]]:
        return self.engine.migration_plan(allocs, kinds=kinds,
                                          remaining=remaining)

    def apply_migration(self, alloc: Allocation,
                        new_placement: List[Tuple[int, int]]) -> Allocation:
        return self.engine.apply_migration(alloc, new_placement)
