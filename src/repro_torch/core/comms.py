"""Analytical collective cost model — the shared language between the
placement layer and the comms layer (DESIGN.md §11).

The placement layer knows each gang's host topology; the comms layer
(``core.collectives``) owns the schedules (flat / ring / hierarchical /
compressed).  Both need the same question answered — *how long does an
all-reduce of B bytes take on this topology under the best schedule?* —
so the pricing lives here, in a numpy-only module imported by both
(``collectives`` must not import ``placement`` and vice versa).

The model is deliberately first-order (Faabric §5.3 accounting): a
schedule's time is its serialized slow-link bytes over the slow-link
bandwidth, plus fast-link bytes over fast bandwidth, plus per-step
latencies and per-collective launch overhead.  It seeds the
``CollectiveTuner`` dispatch table; one-shot measured probes then
overwrite individual entries with ground truth.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

MODES: Tuple[str, ...] = ("flat", "ring", "hierarchical", "compressed")

#: dispatch-table size buckets: power-of-two message sizes from 1 KiB
#: to 1 GiB (below/above clamp to the end buckets)
MIN_BUCKET = 10
MAX_BUCKET = 30

#: default message size priced when a gang's state size is unknown yet
#: (first bind happens before ``init_state``) — 4 MiB, a typical
#: flattened-gradient bucket
DEFAULT_NBYTES = 4 << 20


@dataclasses.dataclass(frozen=True)
class Topology:
    """A gang's placement shape, as the comms layer sees it.

    ``hosts`` — VMs/pods spanned; ``chips`` — total ranks; ``min_fast``
    — the smallest per-host contingent, which bounds the usable
    reduce-scatter fan-in of the hierarchical schedule (the slow hop
    ships ``bytes / min_fast`` in the worst shard)."""

    hosts: int
    chips: int
    min_fast: int

    @classmethod
    def from_placement(cls, placement: Sequence[Tuple[int, int]]
                       ) -> "Topology":
        counts = [int(c) for _, c in placement if c > 0]
        if not counts:
            return cls(1, 1, 1)
        return cls(len(counts), sum(counts), max(1, min(counts)))

    @property
    def key(self) -> Tuple[int, int, int]:
        return (self.hosts, self.chips, self.min_fast)


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    """Measured (or declared) per-link characteristics.

    Bandwidths are bytes/second; the defaults model the paper's cloud
    testbed — ~3 Gbit/s sustained VM-to-VM (slow, DCN) against
    in-memory intra-VM transfers (fast) — and a vectorized codec that
    streams at memory-ish bandwidth with a fixed launch cost."""

    slow_bps: float = 0.4e9        # cross-host (DCN) link
    fast_bps: float = 16e9         # intra-host (ICI / shared memory)
    slow_lat_s: float = 50e-6      # per-step latency across hosts
    fast_lat_s: float = 2e-6       # per-step latency within a host
    launch_s: float = 5e-6         # per-collective-op launch overhead
    codec_bps: float = 8e9         # threshold-select + sparse merge
    codec_lat_s: float = 30e-6     # fixed codec launch cost


def size_bucket(nbytes: Optional[int]) -> int:
    """Message-size bucket: clamped ceil(log2(bytes))."""
    if not nbytes or nbytes <= 0:
        nbytes = DEFAULT_NBYTES
    b = max(1, int(nbytes))
    return min(MAX_BUCKET, max(MIN_BUCKET, int(math.ceil(math.log2(b)))))


def bucket_nbytes(bucket: int) -> int:
    return 1 << bucket


def schedule_cost(topo: Topology, nbytes: int, mode: str,
                  link: Optional[LinkProfile] = None,
                  frac: float = 0.05) -> float:
    """Predicted seconds for one all-reduce of ``nbytes`` (per rank)
    under ``mode`` on ``topo``.  ``inf`` marks an unavailable schedule
    (compressed needs a slow axis to compress across)."""
    link = link or LinkProfile()
    H, n, f = topo.hosts, max(1, topo.chips), max(1, topo.min_fast)
    nbytes = max(1, int(nbytes))
    multi = H > 1
    if n == 1:
        return link.launch_s if mode == "flat" else float("inf")
    if mode == "flat":
        # one fused all-reduce; the whole vector crosses the slow
        # boundary (matches the HLO output-bytes accounting the bench
        # measures), bandwidth-optimal within a host
        slow_b = float(nbytes) if multi else 0.0
        fast_b = 2.0 * nbytes * (n - 1) / n
        slow_steps = 2 * math.ceil(math.log2(H)) if multi else 0
        fast_steps = 2 * math.ceil(math.log2(max(2, f)))
        ops = 1
        codec = 0.0
    elif mode == "ring":
        # one ring over every rank: bandwidth-optimal per link, but the
        # cross-host edges serialize 2(n-1) chunk hops and every step
        # waits on the slowest link — cross-host rings lose on latency
        steps = 2 * (n - 1)
        ring_b = 2.0 * nbytes * (n - 1) / n
        slow_b = ring_b if multi else 0.0
        fast_b = ring_b
        slow_steps = steps if multi else 0
        fast_steps = 0 if multi else steps
        ops = steps
        codec = 0.0
    elif mode == "hierarchical":
        # reduce-scatter(fast) -> all-reduce(slow) -> all-gather(fast):
        # only the per-chip shard (bytes / min_fast) crosses the slow
        # boundary (paper Fig 9)
        slow_b = (nbytes / f) if multi else 0.0
        fast_b = 2.0 * nbytes * (f - 1) / f
        slow_steps = 2 * math.ceil(math.log2(H)) if multi else 0
        fast_steps = 2 * math.ceil(math.log2(max(2, f)))
        ops = 3 if multi else 2
        codec = 0.0
    elif mode == "compressed":
        if not multi or not (0.0 < frac <= 1.0):
            return float("inf")
        shard = nbytes / f
        slow_b = 2.0 * frac * shard          # (vals, idx) pairs
        fast_b = 2.0 * nbytes * (f - 1) / f
        slow_steps = 2 * math.ceil(math.log2(H)) + 2   # two gathers
        fast_steps = 2 * math.ceil(math.log2(max(2, f)))
        ops = 5
        codec = link.codec_lat_s + 2.0 * shard / link.codec_bps
    else:
        raise ValueError(f"unknown collective mode: {mode}")
    return (slow_b / link.slow_bps + fast_b / link.fast_bps
            + slow_steps * link.slow_lat_s + fast_steps * link.fast_lat_s
            + ops * link.launch_s + codec)


def schedule_costs(topo: Topology, nbytes: int,
                   link: Optional[LinkProfile] = None,
                   frac: float = 0.05,
                   modes: Sequence[str] = MODES) -> Dict[str, float]:
    return {m: schedule_cost(topo, nbytes, m, link, frac) for m in modes}


def best_schedule(topo: Topology, nbytes: int,
                  link: Optional[LinkProfile] = None,
                  frac: float = 0.05,
                  modes: Sequence[str] = MODES,
                  measured: Optional[Mapping[str, float]] = None
                  ) -> Tuple[str, float]:
    """(mode, predicted seconds) of the cheapest *available* schedule.
    ``measured`` overrides the analytical estimate per mode (the
    tuner's one-shot probe refinement)."""
    costs = schedule_costs(topo, nbytes, link, frac, modes)
    if measured:
        for m, t in measured.items():
            if m in costs and costs[m] != float("inf"):
                costs[m] = float(t)
    mode = min(costs, key=lambda m: costs[m])
    return mode, costs[mode]


def crossover_bytes(topo: Topology, lo_mode: str, hi_mode: str,
                    link: Optional[LinkProfile] = None,
                    frac: float = 0.05) -> Optional[int]:
    """Smallest bucketed message size where ``hi_mode`` beats
    ``lo_mode`` (None if it never does in the bucket range)."""
    for b in range(MIN_BUCKET, MAX_BUCKET + 1):
        nb = bucket_nbytes(b)
        if (schedule_cost(topo, nb, hi_mode, link, frac)
                < schedule_cost(topo, nb, lo_mode, link, frac)):
            return nb
    return None
