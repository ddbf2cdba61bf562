"""Gang workloads for trace-driven live execution (``Fabric.run_trace``;
PyTorch port of ``repro.runtime.gang_workloads``).

The simulator's discrete-event loop decides *when and where* each trace
job runs (placement, priorities, preemption); these workloads are the
*what* — real torch computations stepped one control point at a time so
concurrent gangs interleave on one fabric:

* ``TrainWorkload`` — a data-parallel training gang (the step machinery
  of ``runtime.train_loop`` without its driver loop), ``pods × data``
  virtual ranks on the gang mesh's device.  State = the train state
  tree; bit-exact across migrate/preempt because the data pipeline is
  (seed, step)-keyed.
* ``ServeWorkload`` — a continuously-batched serving replica
  (``runtime.serve_loop.ContinuousServeLoop``): every step admits due
  arrivals into free slots (mid-generation joins), then decodes one
  token for each occupied lane.  State = the serving state (params +
  slot buffers + cursors + slot bookkeeping), so the same snapshot
  machinery moves a partially-occupied batch.

``workload_factory`` maps trace jobs to workloads by ``Job.workload``
("train" | "serve", falling back on job kind: omp → serve, mpi → train)
— the default factory for tests, benchmarks and examples.

Beside the JAX workloads' arguments, each takes what lets a caller hand
it the JAX package's numbers: ``TrainWorkload(init=, batch_fn=)`` (a
starting train state and the batches of each step) and
``ServeWorkload(params=)``; without them the port draws its own weights
from an explicit ``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import collectives as coll
from repro_torch.core.fabric import GangHandle, GangWorkload
from repro_torch.core.simulator import Job
from repro_torch.data import pipeline as dp
from repro_torch.models import model as model_mod
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.runtime.serve_loop import ContinuousServeLoop, Request
from repro_torch.runtime.train_loop import (make_dp_train_step,
                                            resolve_sync_mode)


class TrainWorkload(GangWorkload):
    """One training gang stepped at control-point granularity.

    ``pods``: the gang mesh's pod count (2 or more for the compressed
    schedule, which compresses across pods).  ``init``: a train state to
    start from instead of the seeded init.  ``batch_fn(data_cfg, step)``:
    the global batch of a step (default ``data.pipeline.make_batch``).
    ``loss_log`` keeps (step, loss) of every step run, the replays after
    a rollback included."""

    def __init__(self, cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                 data_cfg: dp.DataConfig, total_steps: int = 4,
                 sync_mode: str = "hierarchical",
                 compress_frac: float = 0.05, seed: int = 0, pods: int = 1,
                 init: Any = None,
                 batch_fn: Optional[Callable[[dp.DataConfig, int],
                                             Dict[str, Any]]] = None):
        self.cfg, self.opt_cfg, self.data_cfg = cfg, opt_cfg, data_cfg
        self.total_steps = total_steps
        self.sync_mode = sync_mode
        self.compress_frac = compress_frac
        self.seed = seed
        self.pods = pods
        self._init = init
        self.batch_fn = batch_fn or dp.make_batch
        self.state = None
        self.resid = None
        self.steps_done = 0
        self.losses: list = []
        self.loss_log: List[Tuple[int, float]] = []
        self._step_fn = None
        self._mode = sync_mode

    def bind(self, handle: GangHandle) -> None:
        # the global batch must divide over the gang; trace jobs come in
        # arbitrary world sizes, so snap the batch to the nearest
        # divisible size (per-device share of the configured batch, at
        # least one row per device).  The world size is stable across
        # preempt/resume, so each job's data stream stays deterministic.
        world = len(handle.devices)
        per = max(1, self.data_cfg.global_batch // world)
        if self.data_cfg.global_batch != per * world:
            self.data_cfg = dataclasses.replace(self.data_cfg,
                                                global_batch=per * world)
        self._mode = resolve_sync_mode(
            self.sync_mode, handle,
            self.state["params"] if self.state is not None else None)
        mesh = handle.mesh
        self._step_fn = make_dp_train_step(
            self.cfg, self.opt_cfg, mesh.pods, mesh.data, self._mode,
            self.compress_frac)
        if self.state is not None:
            self._init_resid(handle)

    def _init_resid(self, handle: GangHandle) -> None:
        self.resid = None     # drop the old buffer before the new one
        if self._mode == "compressed":
            self.resid = coll.init_residual_buffer(
                self.state["params"], handle.mesh.pods, handle.mesh.data)

    def init_state(self, handle: GangHandle) -> None:
        dev = handle.mesh.device
        if self._init is not None:
            self.state, self._init = self._init, None
        else:
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            self.state = model_mod.init_train_state(gen, self.cfg,
                                                    self.opt_cfg, device=dev)
        self._init_resid(handle)

    def run_step(self, handle: GangHandle) -> Dict[str, Any]:
        dev = handle.mesh.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in
                 self.batch_fn(self.data_cfg, self.steps_done).items()}
        self.state, metrics, self.resid = self._step_fn(self.state, batch,
                                                        self.resid)
        loss = float(metrics["loss"])           # waits for the device
        self.loss_log.append((self.steps_done, loss))
        self.steps_done += 1
        self.losses.append(loss)
        return {"loss": loss, "step": self.steps_done,
                "world": len(handle.devices)}


class ServeWorkload(GangWorkload):
    """One continuously-batched serving gang.

    ``Request.arrival`` is expressed in *steps*: each ``run_step`` first
    admits every due request a free slot can take — mid-generation
    joins, so the batch is usually partially occupied — then decodes one
    token for all occupied lanes.  ``done`` is demand-driven: the gang
    finishes when every request has all its tokens, not at a fixed step
    count.  Admission is a pure function of (slot state, steps_done),
    so a rollback to an earlier snapshot replays the same joins and the
    same tokens — bit-exact resume with mixed occupied/free slots.

    ``params``: the replica's weights (e.g. the JAX package's, carried
    with ``weights.params_from_numpy``); by default ``bind`` draws them
    from a ``torch.Generator`` seeded with ``seed``.
    """

    def __init__(self, cfg: ArchConfig,
                 requests: Optional[Sequence[Request]] = None,
                 prompt_len: int = 8, new_tokens: int = 4, batch: int = 2,
                 slots: int = 0, max_len: int = 32, seed: int = 0,
                 params: Any = None):
        self.cfg = cfg
        self.max_len = max_len
        self.seed = seed
        self._params = params
        if requests is None:
            # ragged prompts + staggered arrivals: the default stream
            # exercises mid-generation joins even in tiny trace tests
            rng = np.random.default_rng(seed)
            requests = [Request(rid=i,
                                prompt=rng.integers(
                                    0, cfg.vocab,
                                    max(1, prompt_len - (i % 2)),
                                    dtype=np.int32),
                                max_new_tokens=new_tokens,
                                arrival=float(i))
                        for i in range(batch)]
        self.requests = list(requests)
        self.slots = int(slots) or max(1, min(len(self.requests), 2))
        # worst-case serial-wave bound; informational (``done`` rules)
        waves = -(-len(self.requests) // self.slots)
        self.total_steps = (1 + int(max(r.arrival for r in self.requests))
                            + waves * max(r.max_new_tokens
                                          for r in self.requests))
        self.steps_done = 0
        self.state = None
        self.loop: Optional[ContinuousServeLoop] = None

    @property
    def done(self) -> bool:
        if self.loop is None or self.steps_done == 0:
            return False
        fin = set(self.loop.done_rids)
        return all(r.rid in fin for r in self.requests)

    def bind(self, handle: GangHandle) -> None:
        if self.loop is None:
            params, self._params = self._params, None
            if params is None:
                dev = handle.mesh.device
                gen = torch.Generator(device=dev).manual_seed(self.seed)
                with torch.no_grad():
                    params = tf.init_params(gen, self.cfg, device=dev)
            self.loop = ContinuousServeLoop(self.cfg, params,
                                            slots=self.slots,
                                            max_len=self.max_len)
        # adopt the new placement (and any restored snapshot) in one move
        self.loop.attach(handle, state=self.state)
        if self.state is not None:
            self._reconcile()
        self.state = self.loop.serve_state()

    def _reconcile(self) -> None:
        """Re-link caller-owned requests after a restore: occupied lanes
        roll their outputs back to the snapshot's decoded prefix,
        finished rids keep theirs, everything else re-queues from
        scratch (a post-snapshot admit must fully replay)."""
        keep = set(self.loop.occupied_rids()) | set(self.loop.done_rids)
        self.loop.adopt_requests(self.requests)
        for r in self.requests:
            if r.rid not in keep:
                r.out.clear()

    def init_state(self, handle: GangHandle) -> None:
        self.state = self.loop.serve_state()

    def run_step(self, handle: GangHandle) -> Dict[str, Any]:
        taken = set(self.loop.occupied_rids()) | set(self.loop.done_rids)
        with torch.no_grad():
            for r in self.requests:         # due arrivals join mid-generation
                if r.rid in taken or r.arrival > self.steps_done:
                    continue
                if self.loop.admit(r) is None:
                    break                   # batch full — retry next step
            self.loop.decode_step()
        self.state = self.loop.serve_state()
        self.steps_done += 1
        return {"decoded": self.loop.stats.decoded_tokens,
                "active": self.loop.active,
                "admitted": self.loop.stats.admitted,
                "step": self.steps_done,
                "outputs": [list(r.out) for r in self.requests]}


def workload_factory(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                     data_cfg: dp.DataConfig, train_steps: int = 3,
                     serve_tokens: int = 3
                     ) -> Callable[[Job], GangWorkload]:
    """Default ``Job -> GangWorkload`` mapping for ``Fabric.run_trace``:
    ``Job.workload`` wins; otherwise omp jobs serve, mpi jobs train."""

    def make(job: Job) -> GangWorkload:
        kind = job.workload or ("serve" if job.kind == "omp" else "train")
        if kind == "serve":
            return ServeWorkload(cfg, new_tokens=serve_tokens,
                                 prompt_len=data_cfg.seq_len,
                                 batch=min(2, data_cfg.global_batch),
                                 max_len=data_cfg.seq_len + serve_tokens + 1,
                                 seed=job.priority + 1)
        return TrainWorkload(cfg, opt_cfg, data_cfg,
                             total_steps=train_steps)
    return make
