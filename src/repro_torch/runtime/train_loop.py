"""The Faabric training runtime over a gang of virtual ranks (PyTorch port
of ``repro.runtime.train_loop``).

A data-parallel gang of Granules, each running the full model replica on
its slice of the global batch, synchronising gradients with the paper's
locality-aware schedules (``core.collectives``), then one AdamW step.  The
JAX runtime binds its gang to a ``Fabric`` of devices; the port's gang is
``pods × data`` virtual ranks on one device, as the JAX tests force host
devices on one CPU: rank ``r`` computes its gradient on batch slice ``r``,
and the ranks' gradients are summed into their pods' shards as they
finish, so one rank's gradient is held at a time.

Every step boundary is a control point (``core.control``): the runtime
checkpoints through ``checkpoint.manager`` (a blocking save of step 0,
then non-blocking saves at the runner's ``checkpoint`` actions) and, at an
injected failure, restarts the gang from the latest checkpoint with a
fresh residual buffer (paper §3.4), as the JAX runtime does.  The
deterministic (seed, step)-keyed batches make the recovered run repeat
the lost steps.

Not ported yet, and refused with ``NotImplementedError`` rather than
ignored: elastic rescale, the ``auto`` sync mode and the placement
settings (slice (c), ``Fabric`` / ``GangHandle`` / ``CollectiveTuner``),
and training the MoE and hybrid families (their kernels have no backward
yet).
A straggler's ``migrate`` action is kept in ``control.history``; the gang
stays where it is until slice (c) gives it somewhere to go.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.core import collectives as coll
from repro_torch.core import control as ctl
from repro_torch.data import pipeline as dp
from repro_torch.models import model as model_mod
from repro_torch.optim import adamw
from repro_torch.weights import tree_leaves

_SLICE_C = "slice (c): the fabric (Fabric, GangHandle, CollectiveTuner)"
_TRAIN_FAMILIES = ("training of the MoE and hybrid families and of xLSTM: "
                   "gradients through moe_gmm, mamba_scan and mlstm")


@dataclasses.dataclass
class RuntimeConfig:
    total_steps: int = 20
    # hierarchical | flat | ring | compressed | auto ("auto" asks the
    # fabric's CollectiveTuner; not ported yet)
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
    placement_policy: str = "binpack"
    elastic: Optional[Any] = None      # an ElasticPolicy of the fabric
    job_kind: Optional[str] = None


def _refuse_unported(cfg: ArchConfig, rt: RuntimeConfig) -> None:
    """Raise for every field that asks for a feature not ported yet."""
    if cfg.family in ("moe", "hybrid", "ssm"):
        raise NotImplementedError(
            f"training the {cfg.family} family ({cfg.name}) is not ported to "
            f"repro_torch yet (ROADMAP, 'The port: slices', "
            f"{_TRAIN_FAMILIES})")
    asks = [
        (bool(rt.rescale_at), "rescale_at", _SLICE_C),
        (rt.elastic is not None, "elastic", _SLICE_C),
        (rt.sync_mode == "auto", 'sync_mode="auto"', _SLICE_C),
        (rt.placement_policy != "binpack", "placement_policy", _SLICE_C),
        (rt.chips_per_host != 4, "chips_per_host", _SLICE_C),
        (rt.job_kind is not None, "job_kind", _SLICE_C),
    ]
    for asked, field, slice_ in asks:
        if asked:
            raise NotImplementedError(
                f"RuntimeConfig.{field} is not ported to repro_torch yet "
                f"(ROADMAP, 'The port: slices', {slice_})")


def params_nbytes(tree) -> int:
    """Bytes of one flattened-f32 gradient sync of ``tree``."""
    return 4 * sum(x.numel() for x in tree_leaves(tree))


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
    """End-to-end training driver over ``ranks`` virtual ranks
    (``rt.pods`` pods of ``ranks // rt.pods``) on one ``device``."""

    def __init__(self, cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                 data_cfg: dp.DataConfig, rt: RuntimeConfig,
                 ranks: int = 1, device="cuda", job_id: str = "job0"):
        _refuse_unported(cfg, rt)
        if rt.sync_mode not in coll.MODES:
            raise ValueError(f"sync_mode {rt.sync_mode!r} not in "
                             f"{coll.MODES + ('auto',)}")
        if ranks < 1 or ranks % rt.pods:
            raise ValueError(f"{ranks} ranks do not divide into {rt.pods} "
                             "pods")
        if rt.sync_mode == "compressed" and rt.pods < 2:
            raise ValueError("sync_mode='compressed' needs pods >= 2 (a "
                             "slow axis to compress)")
        if data_cfg.global_batch % ranks:
            raise ValueError(f"global batch {data_cfg.global_batch} does not "
                             f"divide into {ranks} ranks")
        self.cfg, self.opt_cfg, self.data_cfg, self.rt = (cfg, opt_cfg,
                                                          data_cfg, rt)
        self.device = resolve_device(device)
        self.job_id = job_id
        self.ranks = ranks
        self.pods = rt.pods
        self.data = ranks // rt.pods
        self.sync_mode = rt.sync_mode
        self.ckpt = CheckpointManager(
            rt.ckpt_dir, job_id=job_id,
            incremental_every=rt.incremental_ckpt_every)
        self.control = ctl.ControlPointRunner(
            checkpoint_every=rt.checkpoint_every)
        self.log: List[Dict[str, Any]] = []
        self._step_fn = make_dp_train_step(cfg, opt_cfg, self.pods,
                                           self.data, self.sync_mode,
                                           rt.compress_frac)

    @property
    def mesh_shape(self) -> Dict[str, int]:
        return ({"pod": self.pods, "data": self.data} if self.pods > 1
                else {"data": self.data})

    def init_state(self, seed: int = 0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return model_mod.init_train_state(gen, self.cfg, self.opt_cfg,
                                          device=self.device)

    def _init_resid(self, state):
        return (coll.init_residual_buffer(state["params"], self.pods,
                                          self.data)
                if self.sync_mode == "compressed" else None)

    def run(self, seed: int = 0, state=None,
            batch_fn: Optional[Callable[[dp.DataConfig, int],
                                        Dict[str, Any]]] = None):
        """Train ``rt.total_steps`` steps; returns (state, report) with the
        JAX runtime's report keys.  ``batch_fn(data_cfg, step)`` gives the
        global batch of a step (default ``data.pipeline.make_batch``)."""
        rt = self.rt
        batch_fn = batch_fn or dp.make_batch
        if state is None:
            state = self.init_state(seed)
        resid = self._init_resid(state)
        # checkpoint step semantics: "state before running step k"
        self.ckpt.save(0, state, blocking=True)
        step = 0
        losses: Dict[int, float] = {}
        recoveries = 0
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
            # control point B (a barrier: the gradient sync is complete);
            # migrate and rescale actions wait for slice (c)
            for act in self.control.on_step(step + 1, step_time, self.ranks):
                if act.kind == "checkpoint":
                    self.ckpt.save(step + 1, state, blocking=False)
            step += 1
        self.ckpt.wait()
        return state, {"losses": [losses[s] for s in sorted(losses)],
                       "recoveries": recoveries, "rescales": 0,
                       "migrations": 0, "straggler_migrations": 0,
                       "log": self.log}
