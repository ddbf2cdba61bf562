"""The Faabric training runtime over a gang of virtual ranks (PyTorch port
of ``repro.runtime.train_loop``).

A data-parallel gang of Granules, each running the full model replica on
its slice of the global batch, synchronising gradients with the paper's
locality-aware schedules (``core.collectives``), then one AdamW step.  As
in the JAX runtime, the gang is a ``GangHandle`` on a shared ``Fabric``
(``core.fabric``); the fabric's devices are virtual devices of one torch
device, and the gang runs as ``pods × data`` virtual ranks there, as the
JAX tests force host devices on one CPU: rank ``r`` computes its gradient
on batch slice ``r``, and the ranks' gradients are summed into their
pods' shards as they finish, so one rank's gradient is held at a time.

Every step boundary is a control point (``core.control``): the runtime
checkpoints through ``checkpoint.manager`` (a blocking save of step 0,
then non-blocking saves at the runner's ``checkpoint`` actions); at an
injected failure it restarts the gang from the latest checkpoint with a
fresh residual buffer (paper §3.4); a straggler's ``migrate`` moves the
gang through the handle, and a ``rescale`` (the ``rescale_at`` schedule
or an ``ElasticPolicy``) regrows it on the shared fabric, as the JAX
runtime does.  The deterministic (seed, step)-keyed batches make the
recovered run repeat the lost steps.

Every family the JAX runtime trains trains here: the audio and VLM
families with their batches' extras (encoder frames, image tokens;
``extra_batch_specs``), the MoE family through the moe_gmm kernel's
backward, the hybrid family through mamba_scan's and the xLSTM family
through mlstm's and its sLSTM through slstm's (on the CPU through
autograd of the plain per-token loop, as the JAX package's
``lax.scan``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.core import collectives as coll
from repro_torch.core import control as ctl
from repro_torch.core import elastic as elastic_mod
from repro_torch.core.devices import GangMesh
from repro_torch.core.fabric import Fabric, GangHandle
from repro_torch.data import pipeline as dp
from repro_torch.models import model as model_mod
from repro_torch.optim import adamw
from repro_torch.weights import tree_leaves

@dataclasses.dataclass
class RuntimeConfig:
    total_steps: int = 20
    # hierarchical | flat | ring | compressed | auto ("auto" asks the
    # fabric CollectiveTuner for the best schedule for this gang's
    # placement topology and gradient size, re-resolved after every
    # migrate/rescale)
    sync_mode: str = "hierarchical"
    compress_frac: float = 0.05
    checkpoint_every: int = 10
    ckpt_dir: str = "/tmp/repro-ckpt"
    chips_per_host: int = 4            # host granularity of the fabric
    incremental_ckpt_every: int = 0
    # fault injection: {step: description}; a failure at step s is found
    # before step s runs and restarts the gang from the latest checkpoint
    inject_failures: Dict[int, str] = dataclasses.field(default_factory=dict)
    # elastic schedule: {step: new_world_size}
    rescale_at: Dict[int, int] = dataclasses.field(default_factory=dict)
    pods: int = 1                      # >1: two-level (pod, data) gang
    # gang placement policy on the fabric (binpack/spread/locality)
    placement_policy: str = "binpack"
    # free-chip-driven elastic policy (core.elastic.ElasticPolicy),
    # consulted at every control point; None = only the explicit
    # rescale_at schedule fires
    elastic: Optional[elastic_mod.ElasticPolicy] = None
    # trace job kind of this gang (mpi-compute/mpi-network/omp); routes
    # the per-kind beta of the shared CostModel into elastic grow probes
    job_kind: Optional[str] = None


def extra_batch_specs(cfg: ArchConfig, global_batch: int
                      ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Modality extras (audio frames / vision tokens) of a batch, as
    ``data.pipeline.make_batch`` takes them: name -> (shape, dtype)."""
    if cfg.family == "audio":
        return {"frames": ((global_batch, cfg.enc_seq, cfg.d_model),
                           cfg.torch_dtype())}
    if cfg.family == "vlm":
        return {"img": ((global_batch, cfg.n_img_tokens, cfg.d_model),
                        cfg.torch_dtype())}
    return {}


def family_batch_fn(cfg: ArchConfig) -> Callable[[dp.DataConfig, int],
                                                 Dict[str, Any]]:
    """The default ``batch_fn(data_cfg, step)`` of ``cfg``'s family:
    ``data.pipeline.make_batch`` with the family's extras."""
    return lambda data_cfg, step: dp.make_batch(
        data_cfg, step, extra_batch_specs(cfg, data_cfg.global_batch))


def params_nbytes(tree) -> int:
    """Bytes of one flattened-f32 gradient sync of ``tree`` — the
    message size the CollectiveTuner buckets by."""
    return 4 * sum(x.numel() for x in tree_leaves(tree))


def resolve_sync_mode(mode: str, handle: GangHandle, params=None) -> str:
    """Concrete schedule for ``make_dp_train_step``: "auto" asks the
    fabric tuner for the gang's current placement/size dispatch."""
    if mode != "auto":
        return mode
    nbytes = params_nbytes(params) if params is not None else None
    return handle.best_sync_mode(nbytes)


def make_dp_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                       pods: int, data: int, mode: str,
                       compress_frac: Optional[float] = None) -> Callable:
    """Gang train step over ``pods × data`` virtual ranks:
    (state, global batch, resid) -> (state, metrics, resid).

    Each rank's gradient is computed on its batch slice and handed to the
    sync as it finishes; metrics are the mean over ranks (``pmean``)."""
    grad_fn = model_mod.make_grad_fn(cfg)
    n_ranks = pods * data

    def train_step(state, batch, resid):
        params = state["params"]
        rank_metrics: List[Dict[str, torch.Tensor]] = []

        def rank_grads():
            for r in range(n_ranks):
                (_, m), g = grad_fn(params, dp.shard_slice(batch, r, n_ranks))
                rank_metrics.append(m)
                yield g
                del g           # hold one rank's gradient at a time

        grads, new_resid = coll.tree_sync(
            rank_grads(), mode, pods, data, compress_frac,
            resid if mode == "compressed" else None)
        metrics = {k: sum(m[k] for m in rank_metrics) / n_ranks
                   for k in rank_metrics[0]}
        params, opt, om = adamw.apply(grads, state["opt"], params, opt_cfg)
        del grads
        return ({"params": params, "opt": opt}, {**metrics, **om},
                new_resid if mode == "compressed" else resid)

    return train_step


class FaabricTrainRuntime:
    """End-to-end training driver: a thin loop over one ``GangHandle``.

    The handle owns placement (virtual devices, mesh, GranuleGroup) on a
    shared ``Fabric``; this class owns the training semantics — step
    function, data, checkpoints, and what to do with each control-point
    ``Action``.  Pass ``fabric`` (and the gang's ``devices``, by default
    the whole fabric) to share one fabric between several runtimes and
    serving gangs; by default the runtime builds a private fabric of
    ``ranks`` virtual devices of ``device`` and binds a whole-fabric gang
    (the single-tenant special case)."""

    def __init__(self, cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                 data_cfg: dp.DataConfig, rt: RuntimeConfig,
                 ranks: int = 1, device="cuda", job_id: str = "job0",
                 fabric: Optional[Fabric] = None,
                 devices: Optional[Sequence[Any]] = None,
                 priority: int = 0):
        if rt.sync_mode not in coll.MODES + ("auto",):
            raise ValueError(f"sync_mode {rt.sync_mode!r} not in "
                             f"{coll.MODES + ('auto',)}")
        if fabric is None:
            fabric = Fabric(n_virtual=ranks, device=device,
                            chips_per_host=rt.chips_per_host,
                            policy=rt.placement_policy)
        gang_devices = list(devices if devices is not None
                            else fabric.devices)
        if len(gang_devices) % rt.pods:
            raise ValueError(f"{len(gang_devices)} ranks do not divide "
                             f"into {rt.pods} pods")
        if rt.sync_mode == "compressed" and rt.pods < 2:
            raise ValueError("sync_mode='compressed' needs pods >= 2 (a "
                             "slow axis to compress)")
        if data_cfg.global_batch % len(gang_devices):
            raise ValueError(f"global batch {data_cfg.global_batch} does not "
                             f"divide into {len(gang_devices)} ranks")
        self.cfg, self.opt_cfg, self.data_cfg, self.rt = (cfg, opt_cfg,
                                                          data_cfg, rt)
        self.job_id = job_id
        self.fabric = fabric
        self.handle: GangHandle = fabric.bind(
            job_id, gang_devices, priority=priority, pods=rt.pods,
            policy=rt.placement_policy, kind=rt.job_kind)
        self.ckpt = CheckpointManager(
            rt.ckpt_dir, job_id=job_id,
            incremental_every=rt.incremental_ckpt_every)
        # control points consult the elastic probe, so `rescale` arrives
        # as an Action — the same vocabulary the simulator logs
        self.control = ctl.ControlPointRunner(
            checkpoint_every=rt.checkpoint_every,
            elastic_probe=self._elastic_probe)
        self.handle.control = self.control
        self._probe_step = 0
        self.log: List[Dict[str, Any]] = []
        self.sync_mode = rt.sync_mode
        self._step_fn = None

    # ---- placement views (owned by the handle) -------------------------------
    @property
    def devices(self) -> List[Any]:
        return self.handle.devices

    @property
    def mesh(self) -> GangMesh:
        return self.handle.mesh

    @property
    def device(self) -> torch.device:
        return self.handle.mesh.device

    @property
    def ranks(self) -> int:
        return self.mesh.size

    @property
    def pods(self) -> int:
        return self.mesh.pods

    @property
    def data(self) -> int:
        return self.mesh.data

    @property
    def mesh_shape(self) -> Dict[str, int]:
        return self.mesh.shape

    @property
    def group(self):
        return self.handle.group

    @property
    def engine(self):
        return self.fabric.engine

    def _build(self, state=None):
        self.sync_mode = resolve_sync_mode(
            self.rt.sync_mode, self.handle,
            state["params"] if state is not None else None)
        if self.sync_mode == "compressed" and self.pods < 2:
            raise ValueError(f"a {self.ranks}-rank gang has no pod axis for "
                             "sync_mode='compressed'")
        self._step_fn = make_dp_train_step(
            self.cfg, self.opt_cfg, self.pods, self.data, self.sync_mode,
            self.rt.compress_frac)

    def init_state(self, seed: int = 0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return model_mod.init_train_state(gen, self.cfg, self.opt_cfg,
                                          device=self.device)

    def _init_resid(self, state):
        return (coll.init_residual_buffer(state["params"], self.pods,
                                          self.data)
                if self.sync_mode == "compressed" else None)

    # ---- control-point actions --------------------------------------------------
    def _elastic_probe(self, world: int) -> Optional[int]:
        """Next world size, or None: the explicit schedule first, then the
        free-chip-driven policy (through the shared engine)."""
        step = self._probe_step
        if step in self.rt.rescale_at:
            # cap at what is actually placeable on the *shared* fabric:
            # this gang's chips plus the currently-idle ones (other
            # tenants' allocations are not ours to take)
            return min(self.rt.rescale_at[step],
                       world + self.fabric.engine.idle_chips())
        if self.rt.elastic is not None:
            return self.rt.elastic.decide(world, self.fabric.engine,
                                          kind=self.rt.job_kind)
        return None

    def _migrate_gang(self, state):
        """Straggler response: live-migrate the gang (paper §3.3) through
        the handle — engine-planned consolidation, or a rank rotation
        when the gang already spans the minimum host count.  The
        GranuleGroup is re-addressed in place, so buffered control-plane
        messages and the migration epoch survive the move (Fig 8)."""
        state, _ = self.handle.migrate(state)
        self._build(state)
        return state

    def _rescale(self, state, new_world: int):
        """Grow/shrink the gang to ``new_world`` chips via the handle:
        chips are released to the shared pool and the placement engine
        carves the new sub-mesh under the configured policy (§2.1)."""
        if self.data_cfg.global_batch % new_world:
            raise ValueError(f"global batch {self.data_cfg.global_batch} "
                             f"does not divide into {new_world} ranks")
        state = self.handle.rescale(state, new_world)
        self._build(state)
        return state, self._init_resid(state)

    # ---- main loop ----------------------------------------------------------------
    def run(self, seed: int = 0, state=None,
            batch_fn: Optional[Callable[[dp.DataConfig, int],
                                        Dict[str, Any]]] = None):
        """Train ``rt.total_steps`` steps; returns (state, report) with the
        JAX runtime's report keys.  ``batch_fn(data_cfg, step)`` gives the
        global batch of a step (default ``family_batch_fn``: with the
        family's extras)."""
        rt = self.rt
        batch_fn = batch_fn or family_batch_fn(self.cfg)
        if state is None:
            state = self.init_state(seed)
        self._build(state)
        resid = self._init_resid(state)
        # checkpoint step semantics: "state before running step k"
        self.ckpt.save(0, state, blocking=True)
        step = 0
        losses: Dict[int, float] = {}
        recoveries = rescales = migrations = straggler_migrations = 0
        while step < rt.total_steps:
            # control point A: failure detection before the step
            if step in rt.inject_failures and recoveries < 8:
                rt.inject_failures.pop(step, None)
                state = resid = None    # the gang's device state is lost
                state, step = self.ckpt.restore(device=self.device)
                recoveries += 1
                resid = self._init_resid(state)
                continue
            t0 = time.perf_counter()
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in batch_fn(self.data_cfg, step).items()}
            state, metrics, resid = self._step_fn(state, batch, resid)
            loss = float(metrics["loss"])       # waits for the device
            step_time = time.perf_counter() - t0
            losses[step] = loss
            self.log.append({"step": step, "loss": loss, "time": step_time,
                             "world": self.ranks})
            # control point B (a barrier: the gradient sync is complete)
            self._probe_step = step + 1
            for act in self.handle.control_point(step + 1, step_time):
                if act.kind == "checkpoint":
                    self.ckpt.save(step + 1, state, blocking=False)
                elif act.kind == "migrate":
                    state = self._migrate_gang(state)
                    migrations += 1
                    if act.payload.get("reason") == "straggler":
                        straggler_migrations += 1
                elif act.kind == "rescale":
                    state, resid = self._rescale(state, act.payload["to"])
                    rescales += 1
            step += 1
        self.ckpt.wait()
        return state, {"losses": [losses[s] for s in sorted(losses)],
                       "recoveries": recoveries, "rescales": rescales,
                       "migrations": migrations,
                       "straggler_migrations": straggler_migrations,
                       "log": self.log}

    def release(self) -> None:
        """Return the gang's chips to the shared fabric."""
        self.handle.release()
