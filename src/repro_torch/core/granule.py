"""Granules and Granule groups (paper §3.1, §5.1).

A Granule is the schedulable unit: in Faabric it is one thread/process of a
parallel application; in this TPU adaptation it is **one device's shard of
an SPMD job step**.  A job requesting parallelism *n* is a *gang* of *n*
Granules organised in a ``GranuleGroup`` — the analogue of an MPI
communicator: every Granule has a stable *index* (rank), and the group keeps
an **address table** mapping index -> (host, device) that survives
migration, exactly like the paper's per-VM group metadata replicas.

Message queues: each Granule owns a set of in-memory queues keyed by sender
index.  Queues buffer control-plane messages (migration notices, barrier
tokens, diff payloads) so delivery is independent of Granule placement —
data-plane traffic goes through XLA collectives on the group's mesh.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Dict, List, Sequence, Tuple


@dataclasses.dataclass
class Granule:
    """One schedulable shard of a job."""
    job_id: str
    index: int                      # rank within the GranuleGroup
    host: int                       # host (VM/pod) id
    device: Any = None              # jax device backing this Granule
    semantics: str = "process"      # "thread" (shared memory) | "process"
    state: str = "running"          # running | barrier | migrating | done


class GranuleGroup:
    """Rank-indexed gang with an address table and per-rank queues."""

    def __init__(self, job_id: str, size: int,
                 placement: Sequence[Tuple[int, Any]],
                 semantics: str = "process"):
        assert len(placement) == size
        self.job_id = job_id
        self.size = size
        self.granules = [
            Granule(job_id=job_id, index=i, host=h, device=d,
                    semantics=semantics)
            for i, (h, d) in enumerate(placement)]
        # per-rank FIFO queues: queues[dst][src] -> deque of messages
        self._queues: List[Dict[int, collections.deque]] = [
            collections.defaultdict(collections.deque) for _ in range(size)]
        self._lock = threading.Lock()
        self.epoch = 0              # bumped on every migration

    # ---- address table ----------------------------------------------------
    def address_table(self) -> Dict[int, int]:
        """rank -> host id (the paper's group metadata replica)."""
        return {g.index: g.host for g in self.granules}

    def hosts(self) -> List[int]:
        return sorted({g.host for g in self.granules})

    def ranks_on_host(self, host: int) -> List[int]:
        return [g.index for g in self.granules if g.host == host]

    def leader_of(self, host: int) -> int:
        """VM-leader (paper §5.3): lowest rank on the host."""
        ranks = self.ranks_on_host(host)
        if not ranks:
            raise KeyError(f"no granules on host {host}")
        return min(ranks)

    def devices(self) -> List[Any]:
        return [g.device for g in self.granules]

    def fragmentation(self) -> int:
        """Number of hosts the gang spans (1 = fully co-located)."""
        return len(self.hosts())

    # ---- messaging (control plane) -----------------------------------------
    def send(self, src: int, dst: int, msg: Any) -> None:
        """Asynchronous point-to-point send; never blocks (paper §5.1)."""
        with self._lock:
            self._queues[dst][src].append(msg)

    def recv(self, dst: int, src: int) -> Any:
        with self._lock:
            q = self._queues[dst][src]
            if not q:
                raise LookupError(f"no message from {src} to {dst}")
            return q.popleft()

    def pending(self, dst: int) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues[dst].values())

    def in_flight(self) -> int:
        """Total queued messages — must be 0 at a barrier control point
        before migration is allowed (paper §5.2)."""
        with self._lock:
            return sum(len(q) for qs in self._queues for q in qs.values())

    # ---- migration --------------------------------------------------------
    def migrate(self, index: int, new_host: int, new_device: Any = None
                ) -> None:
        """Re-address one Granule; queues are keyed by rank so buffered
        messages survive the move (paper Fig 8)."""
        if self.in_flight():
            raise RuntimeError(
                "migration requires an empty message plane (barrier point)")
        g = self.granules[index]
        g.host = new_host
        if new_device is not None:
            g.device = new_device
        self.epoch += 1

    def readdress(self, placement: Sequence[Tuple[int, Any]]) -> None:
        """Gang-wide ``migrate``: re-address every rank in place at a
        barrier point.  Rank-keyed queues and granule identity survive —
        only (host, device) change — and the whole move is one migration
        epoch (paper Fig 8's group-metadata update)."""
        assert len(placement) == self.size, "readdress keeps the gang size"
        if self.in_flight():
            raise RuntimeError(
                "migration requires an empty message plane (barrier point)")
        changed = False
        for g, (h, d) in zip(self.granules, placement):
            if g.host != h or g.device is not d:
                g.host, g.device = h, d
                changed = True
        if changed:
            self.epoch += 1

    def resize(self, placement: Sequence[Tuple[int, Any]]) -> None:
        """Elastic grow/shrink in place at a barrier point: surviving
        ranks keep their queues and identity, new ranks start empty,
        dropped ranks disappear (their queues are empty — the barrier
        guarantees no in-flight messages)."""
        if self.in_flight():
            raise RuntimeError(
                "resize requires an empty message plane (barrier point)")
        new_size = len(placement)
        semantics = self.granules[0].semantics if self.granules else "process"
        granules: List[Granule] = []
        for i, (h, d) in enumerate(placement):
            if i < self.size:
                g = self.granules[i]
                g.host, g.device = h, d
            else:
                g = Granule(job_id=self.job_id, index=i, host=h, device=d,
                            semantics=semantics)
            granules.append(g)
        self.granules = granules
        self._queues = (self._queues[:new_size]
                        + [collections.defaultdict(collections.deque)
                           for _ in range(max(0, new_size - self.size))])
        self.size = new_size
        self.epoch += 1

    # ---- collective message schedule (paper Fig 9) -------------------------
    def allreduce_message_schedule(self) -> Dict[str, int]:
        """Count intra-host vs cross-host messages for a VM-leader two-level
        all-reduce vs a flat one (used by benchmarks and the simulator)."""
        hosts = self.hosts()
        leaders = {h: self.leader_of(h) for h in hosts}
        main_host = self.granules[0].host
        intra = cross = 0
        # reduce: every granule -> its leader (intra), leaders -> main leader
        for g in self.granules:
            if g.index == leaders[g.host]:
                continue
            intra += 1
        cross += sum(1 for h in hosts if h != main_host)
        # broadcast: reverse of the same schedule
        cross += sum(1 for h in hosts if h != main_host)
        intra += sum(1 for g in self.granules
                     if g.index != leaders[g.host])
        flat_cross = 2 * sum(1 for g in self.granules
                             if g.host != main_host)
        return {"intra": intra, "cross": cross, "flat_cross": flat_cross}


def make_group_from_devices(job_id: str, devices: Sequence[Any],
                            chips_per_host: int,
                            semantics: str = "process") -> GranuleGroup:
    """Build a GranuleGroup from concrete jax devices; host id is derived
    from the device id so co-location structure is preserved on the
    CPU-host test fabric."""
    placement = [(d.id // chips_per_host, d) for d in devices]
    return GranuleGroup(job_id, len(devices), placement,
                        semantics=semantics)
