"""Locality-aware gradient sync over a gang of virtual ranks (PyTorch port
of the schedules of ``repro.core.collectives``).

The JAX package runs each schedule as a ``shard_map`` body over a
(pod, data) device mesh: the pod is the paper's VM (slow links between
pods), the data axis its fast in-memory queues.  The port's gang lives on
one device as ``pods × data`` virtual ranks (rank ``r`` is pod
``r // data``, data index ``r % data``, as the JAX gang mesh lays
devices out), and each schedule is emulated step for step over them, so
its sums are taken in the JAX schedule's order:

- ``flat``: one psum over every rank;
- ``ring``: a ring all-reduce over the data axis (``ring_allreduce``'s
  2·(n-1) permute steps), then a psum over pods;
- ``hierarchical``: reduce-scatter over data (rank (p, d) owns shard d of
  its pod's sum), psum of the shards over pods, all-gather over data;
- ``compressed``: as hierarchical, but each (pod, data) shard (plus its
  error-feedback residual) goes through the threshold-select codec and
  only its (vals, idx) cross the pod boundary, sum-merged on arrival.
  All shards share one geometry, so ONE codec launch covers every shard.
  ``frac = 1.0`` is bit-exact to hierarchical.

Every rank ends with the same mean, so ``tree_sync`` returns it once.
Ranks come as an iterable and are consumed in rank order: the
hierarchical and compressed schedules add each rank's gradient into its
pod's accumulator as it arrives, so a caller that computes gradients
lazily never holds more than one rank's at a time.

Trees flatten in ``jax.tree.flatten`` order (``weights.tree_leaves``), so
the flat vector, its chunk boundaries and the codec's picks are the JAX
package's.

``CollectiveTuner`` is the JAX module's per-(topology, size bucket)
schedule dispatch, line for line: seeded from the analytic model of
``core.comms`` and refined by one-shot probes (``measure_schedule``).
The port has no compiled HLO to count slow-link bytes in, so its probe
takes them from the ``comms`` model (see ``measure_schedule``).
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import comms, telemetry
from repro_torch.kernels.collective_codec import ops as codec_ops
from repro_torch.weights import tree_leaves, tree_map, tree_unflatten

MODES = ("flat", "ring", "hierarchical", "compressed")


# ---------------------------------------------------------------------------
# Tree <-> padded flat vector (gradient bucketing)
# ---------------------------------------------------------------------------
def flatten_spec(tree, pad_to: int = 1):
    """(spec, pad) for ``flatten_tree``/``unflatten_tree`` of ``tree``."""
    leaves = tree_leaves(tree)
    sizes = [int(x.numel()) for x in leaves]
    pad = (-sum(sizes)) % pad_to
    skeleton = tree_map(lambda _: 0, tree)     # structure, no tensors
    return (skeleton, sizes, [tuple(x.shape) for x in leaves],
            [x.dtype for x in leaves]), pad


def flatten_tree(tree, pad_to: int = 1, out: Optional[torch.Tensor] = None,
                 add: bool = False):
    """Concatenate all leaves into one f32 vector, padded with zeros to a
    multiple of ``pad_to``.  With ``out`` the leaves are written (or, with
    ``add``, added) into it in place of a new vector."""
    spec, pad = flatten_spec(tree, pad_to)
    sizes = spec[1]
    n = sum(sizes) + pad
    leaves = tree_leaves(tree)
    if out is None:
        out = torch.empty(n, dtype=torch.float32, device=leaves[0].device)
        add = False
    elif out.shape != (n,) or out.dtype != torch.float32:
        raise ValueError(f"flatten_tree: out must be ({n},) f32")
    off = 0
    for leaf, size in zip(leaves, sizes):
        dst = out[off:off + size]
        if add:
            dst.add_(leaf.reshape(-1))
        else:
            dst.copy_(leaf.reshape(-1))
        off += size
    if pad and not add:
        out[off:].zero_()
    return out, spec


def unflatten_tree(vec: torch.Tensor, spec):
    """Split ``vec`` back into the spec's leaves, each cast to its own
    dtype (a bf16 model's synced gradients are rounded to bf16 here, as in
    the JAX package)."""
    like, sizes, shapes, dtypes = spec
    parts, off = [], 0
    for size, shape, dtype in zip(sizes, shapes, dtypes):
        parts.append(vec[off:off + size].reshape(shape).to(dtype))
        off += size
    return tree_unflatten(like, parts)


def padded_size(tree, n_ranks: int) -> int:
    total = sum(x.numel() for x in tree_leaves(tree))
    return total + (-total) % n_ranks


def init_residual_buffer(tree, pods: int, data: int,
                         device=None) -> torch.Tensor:
    """Zero error-feedback buffer, (pods, padded flat size) f32: row p,
    shard d is rank (p, d)'s residual, as the JAX buffer sharded
    P('pod', 'data')."""
    leaves = tree_leaves(tree)
    dev = device if device is not None else leaves[0].device
    return torch.zeros((pods, padded_size(tree, pods * data)),
                       dtype=torch.float32, device=dev)


# ---------------------------------------------------------------------------
# The schedules over virtual ranks
# ---------------------------------------------------------------------------
def _ranks(per_rank: Iterable[Any], n_ranks: int):
    """Yield (rank, tree) in rank order; raise unless there are exactly
    ``n_ranks``."""
    count = 0
    for r, tree in enumerate(per_rank):
        if r >= n_ranks:
            raise ValueError(f"tree_sync: more than {n_ranks} ranks")
        yield r, tree
        del tree                # the caller's copy is its only reference
        count = r + 1
    if count != n_ranks:
        raise ValueError(f"tree_sync: got {count} ranks, need {n_ranks}")


def _pod_sums(per_rank, pods: int, data: int):
    """Sum each pod's ranks into one vector as the ranks arrive: the
    reduce-scatter over the data axis, where shard d of pod p's vector is
    the shard rank (p, d) owns.  Returns (pods, padded) f32 and the spec."""
    n_ranks = pods * data
    acc = spec = None
    for r, tree in _ranks(per_rank, n_ranks):
        if acc is None:
            spec, pad = flatten_spec(tree, n_ranks)
            acc = torch.empty((pods, sum(spec[1]) + pad),
                              dtype=torch.float32,
                              device=tree_leaves(tree)[0].device)
        flatten_tree(tree, n_ranks, out=acc[r // data], add=r % data != 0)
        del tree
    return acc, spec


def _ring_allreduce(chunks: List[torch.Tensor]) -> torch.Tensor:
    """``ring_allreduce`` over one pod's ranks, permute for permute: each
    rank's vector as (n, len/n) chunks; 2·(n-1) steps, rank r sending to
    r+1.  Returns the (common) result."""
    n = len(chunks)
    if n == 1:
        return chunks[0].reshape(-1)
    for s in range(n - 1):          # reduce-scatter ring
        sent = [chunks[r][(r - s) % n].clone() for r in range(n)]
        for r in range(n):
            dst = (r + 1) % n
            chunks[dst][(dst - s - 1) % n].add_(sent[r])
    for s in range(n - 1):          # all-gather ring
        sent = [chunks[r][(r - s + 1) % n].clone() for r in range(n)]
        for r in range(n):
            dst = (r + 1) % n
            chunks[dst][(dst - s) % n].copy_(sent[r])
    return chunks[0].reshape(-1)


def reference_topk_select(vec: torch.Tensor, frac: float):
    """The pre-tuner codec: a *global* top-k over the whole shard, which
    the chunk-select codec (``kernels/collective_codec``) replaced; kept
    as the reference the codec is timed against.  Returns (sel, idx,
    residual): the k = max(1, int(n frac)) entries of largest magnitude,
    their indices (by descending magnitude; ties in ``torch.topk``'s
    order, which may differ from ``jax.lax.top_k``'s) and the shard with
    them zeroed."""
    k = max(1, int(vec.numel() * frac))
    _, idx = torch.topk(vec.abs(), k)
    residual = vec.clone()
    residual[idx] = 0.0
    return vec[idx], idx, residual


def tree_sync(per_rank: Iterable[Any], mode: str, pods: int, data: int,
              compress_frac: Optional[float] = None,
              resid: Optional[torch.Tensor] = None
              ) -> Tuple[Any, Optional[torch.Tensor]]:
    """All-reduce-mean the gradient trees of ``pods × data`` ranks.

    ``per_rank``: the ranks' trees (or flat tensors), in rank order, as
    any iterable (a list, a generator, the rows of a stacked tensor).
    ``resid``: the (pods, padded) error-feedback buffer of mode
    ``compressed``; its shards are overwritten in place with the codec's
    new residual.  Returns (mean tree, new residual or None)."""
    if mode not in MODES:
        raise ValueError(f"tree_sync: mode {mode!r} not in {MODES}")
    n_ranks = pods * data
    new_resid = None
    if mode == "flat":
        out = None
        for _, tree in _ranks(per_rank, n_ranks):
            vec, spec = flatten_tree(tree, n_ranks)
            out = vec if out is None else out.add_(vec)
            del tree, vec
    elif mode == "ring":
        out = None
        ring: List[torch.Tensor] = []
        for _, tree in _ranks(per_rank, n_ranks):
            vec, spec = flatten_tree(tree, n_ranks)
            ring.append(vec.reshape(data, -1))
            del tree, vec
            if len(ring) == data:
                pod_out = _ring_allreduce(ring)
                ring = []
                out = pod_out if out is None else out.add_(pod_out)
    elif mode == "hierarchical":
        acc, spec = _pod_sums(per_rank, pods, data)
        out = acc[0]
        for p in range(1, pods):
            out.add_(acc[p])
    else:
        if compress_frac is None or pods < 2:
            raise ValueError("tree_sync: compressed needs compress_frac and "
                             "pods >= 2 (a slow axis)")
        acc, spec = _pod_sums(per_rank, pods, data)
        length = acc.shape[1] // data
        if resid is not None:
            if resid.shape != acc.shape:
                raise ValueError(f"tree_sync: residual {tuple(resid.shape)}"
                                 f", need {tuple(acc.shape)}")
            acc.add_(resid)
        shards = acc.view(pods * data, length)
        vals, idx, new_resid = codec_ops.select_codec_shards(
            shards, frac=float(compress_frac),
            out_resid=resid.view(pods * data, length)
            if resid is not None else None)
        del acc, shards
        out = torch.zeros(data * length, dtype=torch.float32,
                          device=vals.device)
        for d in range(data):
            merged = out[d * length:(d + 1) * length]
            for p in range(pods):
                r = p * data + d
                merged.index_add_(0, idx[r], vals[r])
        new_resid = new_resid.view(pods, data * length)
    out.div_(n_ranks)
    return unflatten_tree(out, spec), new_resid


# ---------------------------------------------------------------------------
# Topology-tuned schedule dispatch (DESIGN.md §11)
# ---------------------------------------------------------------------------
def modeled_slowlink_bytes(topo: comms.Topology, nbytes: int, mode: str,
                           link: Optional[comms.LinkProfile] = None,
                           frac: float = 0.05) -> float:
    """Per-rank bytes that one all-reduce of ``nbytes`` under ``mode``
    moves across the host (pod) boundary of ``topo``, by the analytic
    model: the part of ``comms.schedule_cost`` that the slow link's
    bandwidth prices, times that bandwidth.  (The JAX probe counts them
    in the compiled HLO; the port compiles no HLO.)"""
    link = link or comms.LinkProfile()
    free = dataclasses.replace(link, slow_bps=float("inf"))
    slow_s = (comms.schedule_cost(topo, nbytes, mode, link, frac)
              - comms.schedule_cost(topo, nbytes, mode, free, frac))
    return slow_s * link.slow_bps


def measure_schedule(mesh, mode: str, nbytes: int,
                     compress_frac: float = 0.05, reps: int = 3,
                     link: Optional[comms.LinkProfile] = None) -> dict:
    """One-shot measured probe of one collective schedule on a gang mesh
    (``core.devices.GangMesh``).

    Times ``reps`` runs of the port's ``tree_sync`` under ``mode`` over
    the mesh's ``pods × data`` virtual ranks, each holding its shard of an
    ``nbytes`` f32 tree (as the JAX probe's tree is sharded over its
    devices), on the mesh's device.  The ranks share one card, so no link
    between them is slow: as the JAX probe does on its CPU fabric
    (``emulate_slow``), the probe adds the modelled slow-link time, the
    schedule's slow-link bytes (``modeled_slowlink_bytes``) over the
    profile's slow-link bandwidth, so schedules are compared under the
    topology they are tuned for.  Returns ``{"wall_s", "slowlink_bytes",
    "effective_s"}`` per all-reduce."""
    link = link or comms.LinkProfile()
    n_dev = mesh.size
    n = max(n_dev, int(nbytes) // 4)
    n += (-n) % n_dev
    per = n // n_dev
    rows = torch.ones((n_dev, per), dtype=torch.float32, device=mesh.device)
    resid = (init_residual_buffer({"g": rows[0]}, mesh.pods, mesh.data)
             if mode == "compressed" else None)

    def run():
        out, _ = tree_sync(({"g": rows[r]} for r in range(n_dev)), mode,
                           mesh.pods, mesh.data, compress_frac, resid)
        return out

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    run()                       # warm-up: first launches, allocations
    sync()
    t0 = _time.perf_counter()
    for _ in range(reps):
        run()
    sync()
    wall = (_time.perf_counter() - t0) / max(1, reps)
    topo = comms.Topology(mesh.pods, n_dev, mesh.data)
    slow_b = int(modeled_slowlink_bytes(topo, 4 * per, mode, link,
                                        compress_frac))
    return {"wall_s": wall, "slowlink_bytes": slow_b,
            "effective_s": wall + slow_b / link.slow_bps}


class CollectiveTuner:
    """Per-(topology, message-size-bucket) collective schedule dispatch.

    The table maps ``(Topology.key, size_bucket)`` to the schedule the
    comms layer should run — flat / ring / hierarchical / compressed —
    seeded from the analytical cost model in ``core.comms`` (slow-link
    bytes x per-link bandwidth + per-step latency) and refined by
    one-shot measured probes (``probe``/``record_probe``), which
    overwrite the analytical estimate for the probed (topology, bucket,
    mode) and re-derive the dispatch entry.

    ``Fabric`` owns one; ``GangHandle`` re-derives a gang's entries
    after every placement change (attach / migrate / evacuate /
    rescale) via ``on_placement_change`` and drops them on release.
    """

    def __init__(self, link: Optional[comms.LinkProfile] = None,
                 compress_frac: float = 0.05,
                 modes: Sequence[str] = comms.MODES):
        self.link = link or comms.LinkProfile()
        self.compress_frac = float(compress_frac)
        self.modes = tuple(modes)
        # (topo.key, bucket) -> (mode, predicted seconds)
        self.table: Dict[Tuple[Tuple[int, int, int], int],
                         Tuple[str, float]] = {}
        # (topo.key, bucket) -> {mode: measured seconds} probe overrides
        self.measured: Dict[Tuple[Tuple[int, int, int], int],
                            Dict[str, float]] = {}
        self.gangs: Dict[str, comms.Topology] = {}
        self.rederivations = 0

    # ---- derivation --------------------------------------------------------
    def _derive(self, topo: comms.Topology, bucket: int,
                modes: Optional[Sequence[str]] = None
                ) -> Tuple[str, float]:
        entry = comms.best_schedule(
            topo, comms.bucket_nbytes(bucket), self.link,
            self.compress_frac, modes or self.modes,
            measured=self.measured.get((topo.key, bucket)))
        if modes is None:
            self.table[(topo.key, bucket)] = entry
        return entry

    def on_placement_change(self, job_id: str,
                            placement: Sequence[Tuple[int, int]]
                            ) -> comms.Topology:
        """Re-derive the dispatch entries for a gang whose placement
        just changed (attach / migrate / evacuate / rescale)."""
        tel = telemetry.get()
        t0 = _time.perf_counter() if tel.enabled else 0.0
        topo = comms.Topology.from_placement(placement)
        self.gangs[job_id] = topo
        self.rederivations += 1
        for b in range(comms.MIN_BUCKET, comms.MAX_BUCKET + 1):
            self._derive(topo, b)
        if tel.enabled:
            tel.count("collective.rederivations")
            tel.span_at("collective.rederive", t0, _time.perf_counter(),
                        track="collectives", clock="wall", job=job_id,
                        hosts=topo.hosts, chips=topo.chips)
        return topo

    def forget(self, job_id: str) -> None:
        self.gangs.pop(job_id, None)

    # ---- dispatch ----------------------------------------------------------
    def _topo(self, gang_or_placement) -> comms.Topology:
        if isinstance(gang_or_placement, comms.Topology):
            return gang_or_placement
        if isinstance(gang_or_placement, str):
            topo = self.gangs.get(gang_or_placement)
            return topo if topo is not None else comms.Topology(1, 1, 1)
        return comms.Topology.from_placement(gang_or_placement)

    def mode_for(self, gang_or_placement, nbytes: Optional[int] = None,
                 allowed: Optional[Sequence[str]] = None) -> str:
        """The schedule to run for one collective: dispatch-table
        lookup by (gang topology, size bucket), deriving on miss.
        ``allowed`` restricts the choice (a single-axis mesh cannot run
        the pod-level compressed/hierarchical schedules)."""
        topo = self._topo(gang_or_placement)
        bucket = comms.size_bucket(nbytes)
        if allowed is not None and set(allowed) != set(self.modes):
            mode = self._derive(topo, bucket, modes=tuple(allowed))[0]
        else:
            entry = self.table.get((topo.key, bucket))
            if entry is None:
                entry = self._derive(topo, bucket)
            mode = entry[0]
        tel = telemetry.get()
        if tel.enabled:
            tel.count(f"collective.dispatch.{mode}")
        return mode

    def predicted_time(self, gang_or_placement,
                       nbytes: Optional[int] = None) -> float:
        """Seconds for the dispatched (best) schedule — the quantity
        ``CostModel.collective_time`` prices placements with."""
        topo = self._topo(gang_or_placement)
        bucket = comms.size_bucket(nbytes)
        entry = self.table.get((topo.key, bucket))
        if entry is None:
            entry = self._derive(topo, bucket)
        return entry[1]

    # ---- measured refinement ----------------------------------------------
    def record_probe(self, gang_or_placement, nbytes: int, mode: str,
                     seconds: float) -> None:
        """Fold one measured (topology, bucket, mode) timing into the
        table: the measurement overrides the analytical estimate and
        the dispatch entry is re-derived."""
        topo = self._topo(gang_or_placement)
        bucket = comms.size_bucket(nbytes)
        self.measured.setdefault((topo.key, bucket), {})[mode] = \
            float(seconds)
        self._derive(topo, bucket)
        tel = telemetry.get()
        if tel.enabled:
            tel.count("collective.probes")
            tel.observe(f"collective.probe_s.{mode}", float(seconds))
            tel.instant("collective.probe", track="collectives",
                        mode=mode, bucket=bucket,
                        seconds=float(seconds))

    def probe(self, mesh, nbytes: int = comms.DEFAULT_NBYTES,
              modes: Optional[Sequence[str]] = None, reps: int = 2
              ) -> Dict[str, float]:
        """Measure every available schedule once on ``mesh`` (a
        ``GangMesh``) and refine the dispatch entry for its topology
        (a one-shot calibration, not a hot path)."""
        pods = mesh.pods
        chips = mesh.size
        topo = comms.Topology(pods, chips, max(1, chips // max(1, pods)))
        out: Dict[str, float] = {}
        for mode in (modes or self.modes):
            if mode == "compressed" and pods <= 1:
                continue
            m = measure_schedule(mesh, mode, nbytes,
                                 self.compress_frac, reps, self.link)
            out[mode] = m["effective_s"]
            self.record_probe(topo, nbytes, mode, m["effective_s"])
        return out
