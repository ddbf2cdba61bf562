"""The port's shared Fabric against the JAX package's (tests/test_fabric.py,
tests/test_dist.py and the fabric hook case of tests/test_collectives.py).

* The pure cases of tests/test_fabric.py (preemption plans, ragged
  capacities, generation speeds, the device pool under churn, GranuleGroup
  re-addressing) run again on the port's copies, as in
  tests/test_torch_control_plane.py.
* The live cases, which the JAX tests run in an 8-device subprocess, run
  in-process on a port Fabric of 8 virtual CPU devices, with reduced
  llama3.2-1b (1 layer, vocab 128, seq 8, batch 8), with the JAX tests'
  assertions as they stand (bit-exact where they are bit-exact).
* tests/test_dist.py's elastic loss invariance, migration between device
  sets and straggler migration, on the port runtime.
* tests/test_serving.py's grow-with-drain case: a serve gang under a
  breach grows from 2 to 4 chips by draining a 6-chip training gang to
  3, after a ``ServeAutoscaler`` on the full pool asks for it ("need").
* One live trace with two preemptions and a hard host failure runs in
  both packages (JAX in an 8-device subprocess; the port from the JAX
  init, serve weights and batches, carried as numpy): the port's
  ``predict_trace`` and live Action logs equal JAX's, the completion
  orders are equal, train losses agree within test_torch_train_loop.py's
  tolerance (rtol = atol = 1e-5) and the served tokens are equal.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import _port_mirror
from repro.configs import registry as jreg
from repro.data import pipeline as JD
from repro.models import model as JM
from repro.models import transformer as JT
from repro.optim import adamw as JAW
from repro_torch.configs.registry import reduced_config
from repro_torch.core import diffsync, migration, snapshot as snap_mod
from repro_torch.core.devices import virtual_devices
from repro_torch.core.fabric import Fabric
from repro_torch.core.fleet import FleetEvent
from repro_torch.core.placement import CostModel, LocalityScoredPolicy, \
    ShardedPlacementEngine
from repro_torch.core.simulator import Job, hetero_speeds
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import transformer as tf
from repro_torch.core.elastic import ElasticPolicy
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.admission import ServeAutoscaler, ServeSLO
from repro_torch.runtime.gang_workloads import (ServeWorkload, TrainWorkload,
                                                workload_factory)
from repro_torch.runtime.serve_loop import Request, ServeLoop
from repro_torch.runtime.train_loop import FaabricTrainRuntime, RuntimeConfig
from repro_torch.weights import (params_from_numpy, state_from_numpy,
                                 tree_leaves)

torch.set_num_threads(2)   # several test workers share the cores

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PURE = ("test_preemption_plan_evicts_lowest_priority_first",
        "test_preemption_plan_respects_max_victims",
        "test_engine_ragged_capacities",
        "test_infer_host_speeds_uniform_pool_is_homogeneous",
        "test_join_hosts_infers_generation_speeds",
        "test_fabric_pool_churn_drops_doomed_devices",
        "test_readdress_preserves_group_identity_and_epoch",
        "test_resize_keeps_surviving_rank_queues")
_MOD = _port_mirror.export(globals(), "test_fabric.py", take=PURE)


def test_mirror_covers_the_pure_cases():
    _port_mirror.check_coverage(globals(), "test_fabric.py", _MOD, PURE)


def test_fabric_pool_is_virtual_devices_of_one_device():
    fab = Fabric(device="cpu")
    assert [d.index for d in fab.devices] == list(range(8))
    assert {d.device for d in fab.devices} == {torch.device("cpu")}
    assert {d.device_kind for d in fab.devices} == {"cpu"}
    assert fab.engine.hosts == 2 and fab.engine.speeds is None
    assert len(Fabric(n_virtual=3, chips_per_host=2,
                      device="cpu").engine.capacities) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Fabric()


CFG = reduced_config("llama3.2-1b").with_(n_layers=1, vocab=128)
DCFG = DataConfig(vocab=128, seq_len=8, global_batch=8)
OCFG = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)


def _fabric(**kw):
    return Fabric(chips_per_host=2, device="cpu", **kw)


def _steps(wl, handle, k):
    for _ in range(k):
        wl.run_step(handle)


def _factory(**kw):
    return workload_factory(CFG, OCFG, DCFG, **{"train_steps": 3,
                                                "serve_tokens": 3, **kw})


# ---------------------------------------------------------------------------
# tests/test_fabric.py's live cases, in-process on 8 virtual CPU devices
# ---------------------------------------------------------------------------
def test_preemption_evicts_checkpoints_and_resumes_bit_exact():
    fab = _fabric()
    h = fab.allocate("ref", 8)
    ref = TrainWorkload(CFG, OCFG, DCFG, total_steps=6)
    ref.bind(h)
    ref.init_state(h)
    _steps(ref, h, 6)
    h.release()
    assert fab.idle_chips() == 8

    low = fab.allocate("low", 8, priority=0)
    wl = TrainWorkload(CFG, OCFG, DCFG, total_steps=6)
    wl.bind(low)
    wl.init_state(low)
    _steps(wl, low, 3)
    victims = fab.preemption_plan(4, priority=5)
    assert victims == ["low"], victims
    snap = low.preempt(wl.state, wl.steps_done)
    assert fab.idle_chips() == 8 and low.status == "preempted"
    assert snap.fingerprint == snap_mod.fingerprint(wl.state)
    hi = fab.allocate("hi", 4, priority=5)
    hiwl = TrainWorkload(CFG, OCFG, DCFG, total_steps=2)
    hiwl.bind(hi)
    hiwl.init_state(hi)
    _steps(hiwl, hi, 2)
    hi.release()
    state, step = low.resume()          # fingerprint-verified restore
    assert step == 3 and low.status == "running"
    wl.state = state
    wl.bind(low)
    _steps(wl, low, 3)
    np.testing.assert_allclose(ref.losses, wl.losses, atol=1e-6)
    low.release()
    assert fab.idle_chips() == 8 and not fab.gangs


def test_resume_refuses_a_snapshot_that_is_not_bit_exact():
    fab = _fabric()
    g = fab.allocate("g", 2)
    wl = TrainWorkload(CFG, OCFG, DCFG, total_steps=2)
    wl.bind(g)
    wl.init_state(g)
    g.preempt(wl.state, 0)
    g.snapshot.state["params"]["embed"][0, 0] += 1.0
    with pytest.raises(RuntimeError, match="bit-exact"):
        g.resume()


def test_concurrent_train_and_serve_gangs_share_fabric():
    fab = _fabric()
    a = fab.allocate("train0", 4, priority=0)
    b = fab.allocate("serve0", 2, priority=1)
    assert a is not None and b is not None
    assert not (set(a.devices) & set(b.devices))
    assert fab.idle_chips() == 2
    ta = TrainWorkload(CFG, OCFG, DCFG, total_steps=3)
    ta.bind(a)
    ta.init_state(a)
    sb = ServeWorkload(CFG, prompt_len=8, new_tokens=3, batch=2, max_len=16)
    sb.bind(b)
    sb.init_state(b)
    while not (ta.done and sb.done):
        if not ta.done:
            ta.run_step(a)
        if not sb.done:
            sb.run_step(b)
    outs = [r.out for r in sb.requests]
    assert all(len(o) == 3 for o in outs), outs
    assert len(ta.losses) == 3 and np.isfinite(ta.losses).all()
    a.release()
    b.release()
    assert fab.idle_chips() == 8 and not fab.gangs


def test_shared_fabric_rescale_caps_and_serve_resume_fresh_loop(tmp_path):
    # a scheduled rescale beyond shared-fabric capacity is skipped
    # (other tenants' chips are not ours to take), not a crash
    dcfg = DataConfig(vocab=128, seq_len=8, global_batch=12)
    fab = _fabric()
    rt = FaabricTrainRuntime(CFG, OCFG, dcfg, RuntimeConfig(
        total_steps=4, checkpoint_every=100, ckpt_dir=str(tmp_path / "a"),
        rescale_at={2: 8}), devices=fab.devices[2:8], fabric=fab,
        job_id="t0")
    other = fab.allocate("tenant", 2, priority=1)
    out = rt.run(seed=0)[1]
    assert out["rescales"] == 0 and len(rt.devices) == 6
    rt.release()
    other.release()
    # ...but a placeable partial grow (4 -> world+idle = 6) fires
    fab = _fabric()
    rt = FaabricTrainRuntime(CFG, OCFG, dcfg, RuntimeConfig(
        total_steps=4, checkpoint_every=100, ckpt_dir=str(tmp_path / "b"),
        rescale_at={2: 8}), devices=fab.devices[:4], fabric=fab,
        job_id="t1")
    other = fab.allocate("tenant", 2)
    out = rt.run(seed=0)[1]
    assert out["rescales"] == 1 and len(rt.devices) == 6
    rt.release()
    other.release()
    assert fab.idle_chips() == 8

    # run_trace with an explicit policy must not overwrite the fabric
    # engine's configured default
    fab2 = _fabric(policy="locality")
    before = fab2.engine.default_policy
    fab2.run_trace([Job("a", "mpi-compute", 2, 50.0, workload="train")],
                   _factory(train_steps=1), policy="binpack")
    assert fab2.engine.default_policy is before
    assert isinstance(before, LocalityScoredPolicy)

    # a serving snapshot restores into a FRESH ServeLoop (new driver
    # process): host-side request bookkeeping rides in the snapshot
    params = tf.init_params(torch.Generator().manual_seed(0), CFG,
                            device="cpu")
    mk = lambda: [Request(rid=i,  # noqa: E731
                          prompt=np.asarray([1, 2, 3, 4, 5, 6, 7, 8],
                                            np.int32),
                          max_new_tokens=6) for i in range(2)]
    with torch.no_grad():
        ref = [r.out for r in ServeLoop(CFG, params, max_len=32).run(mk())]
        l1 = ServeLoop(CFG, params, max_len=32)
        l1.start(mk())
        l1.decode_step()
        l1.decode_step()
        snap = snap_mod.take("serve", 2, l1.serve_state())
        l2 = ServeLoop(CFG, params, max_len=32)
        l2.load_serve_state(snap_mod.restore(snap, "cpu"))
        rebuilt = l2._reqs                  # drained to None on finish
        assert rebuilt is not None and not l2.done
        while l2.decode_step():
            pass
    assert [r.out for r in rebuilt] == ref


def _same_tree(a, b):
    """Leaves equal bit for bit (tensors: dtype, shape and values)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        (x.dtype == y.dtype and torch.equal(x, y))
        if isinstance(x, torch.Tensor) else np.array_equal(x, y)
        for x, y in zip(la, lb))


def test_fabric_grow_with_drain_reclaims_from_donors():
    """tests/test_serving.py:254 on the port's Fabric (8 virtual CPU
    devices), with the autoscaler's "need" that asks for the grow and
    the donor's state checked bit for bit across its drain."""
    fab = _fabric()                                 # 8 chips
    t = fab.allocate("train0", 6, priority=0)
    s = fab.allocate("serve0", 2, priority=5)
    twl = TrainWorkload(CFG, OCFG, DCFG, total_steps=8)
    twl.bind(t)
    twl.init_state(t)
    twl.run_step(t)
    swl = ServeWorkload(CFG, new_tokens=3, batch=2, max_len=16)
    swl.bind(s)
    swl.init_state(s)
    swl.run_step(s)
    # a breach on a full pool: no grow, no clone fits -> "need" 4
    scaler = ServeAutoscaler(ElasticPolicy(min_world=1, max_world=8),
                             fab.engine, slo=ServeSLO(target_p99_s=0.5),
                             base_world=2)
    acts = scaler.decide(0.0, queue_depth=0, p99=1.0,
                         gang_worlds={"serve0": s.n})
    assert [(a.kind, a.world) for a in acts] == [("need", 4)]
    before = [x.clone() if isinstance(x, torch.Tensor) else x
              for x in tree_leaves(twl.state)]
    # the training donor drains (graceful shrink, zero lost work)
    state, donors = fab.grow_with_drain(
        s, swl.state, acts[0].world, donors=[(t, twl.state, 2)])
    assert s.n == 4 and t.n == 3, (s.n, t.n)
    assert set(donors) == {"train0"}
    assert _same_tree(before, donors["train0"])
    moves = [(e["kind"], e.get("to")) for e in t.epoch_log
             if e["kind"] == "rescale"]
    assert moves == [("rescale", 3)]
    twl.state = donors["train0"]
    twl.bind(t)
    swl.state = state
    swl.bind(s)
    # both gangs keep running on their new placements
    twl.run_step(t)
    swl.run_step(s)
    assert len(twl.losses) == 2 and np.isfinite(twl.losses).all()
    assert twl.data_cfg.global_batch == 6
    # donors exhausted at their floor -> the grow raises
    with pytest.raises(RuntimeError):
        fab.grow_with_drain(s, swl.state, 8, donors=[(t, twl.state, 2)])
    assert s.n == 4 and t.n == 3      # 3 // 2 is below the floor of 2


@pytest.mark.parametrize("continuous", [False, True])
def test_serve_loops_attach_to_a_gang(continuous):
    """Both serve loops follow a gang: ``attach(handle, state=...)``
    adopts a serving state moved onto the gang's devices mid-generation,
    and decoding goes on to the uninterrupted loop's tokens."""
    from repro_torch.core import elastic
    from repro_torch.runtime.serve_loop import ContinuousServeLoop
    params = tf.init_params(torch.Generator().manual_seed(1), CFG,
                            device="cpu")
    mk = lambda: [Request(rid=i,  # noqa: E731
                          prompt=np.arange(1, 7 + i, dtype=np.int32),
                          max_new_tokens=5) for i in range(2)]

    def new_loop():
        return (ContinuousServeLoop(CFG, params, slots=2, max_len=32)
                if continuous else ServeLoop(CFG, params, max_len=32))
    with torch.no_grad():
        ref = [r.out for r in new_loop().run(
            mk() if continuous else [Request(rid=i, prompt=np.arange(
                1, 7, dtype=np.int32), max_new_tokens=5)
                for i in range(2)])]
        fab = _fabric()
        g = fab.allocate("s", 2)
        loop = new_loop()
        loop.attach(g)
        assert loop.handle is g and loop.device == g.mesh.device
        reqs = mk() if continuous else [
            Request(rid=i, prompt=np.arange(1, 7, dtype=np.int32),
                    max_new_tokens=5) for i in range(2)]
        if continuous:
            for r in reqs:
                loop.admit(r)
        else:
            loop.start(reqs)
        loop.decode_step()
        loop.decode_step()
        state, _ = g.migrate(loop.serve_state())
        fresh = new_loop()
        fresh.attach(g, state=state)
        if continuous:
            fresh.adopt_requests(reqs)
            while not fresh.done:
                fresh.decode_step()
        else:
            reqs = fresh._reqs
            while fresh.decode_step():
                pass
    assert [r.out for r in reqs] == ref
    assert g.epoch_log[-1]["kind"] == "migrate"
    assert elastic.make_dp_mesh(g.devices).pods == 1


def test_hetero_fabric_run_trace_matches_prediction():
    speeds = hetero_speeds(4, slow_fraction=0.5, slow=0.5)
    fab = _fabric(policy="locality", speeds=list(speeds))
    assert fab.engine.heterogeneous
    jobs = [
        Job("train-net", "mpi-network", 4, 120.0, arrival=0.0, priority=0,
            workload="train"),
        Job("train-cmp", "mpi-compute", 4, 120.0, arrival=0.0, priority=0,
            workload="train"),
        Job("serve-0", "omp", 2, 60.0, arrival=1.0, priority=1,
            workload="serve"),
    ]
    pred = fab.predict_trace(jobs, preempt=True)
    starts = {a.payload["job"]: a.payload["placement"]
              for a in pred.actions if a.kind == "start"}
    fast = {h for h, s in enumerate(speeds) if s == 1.0}
    assert {h for h, _ in starts["train-net"]} <= fast, starts
    ex = fab.run_trace(jobs, _factory(), preempt=True)
    assert ex.result.finish_order == pred.finish_order
    live_starts = {a.payload["job"]: a.payload["placement"]
                   for a in ex.result.actions if a.kind == "start"}
    assert live_starts == starts      # placement-for-placement
    assert fab.idle_chips() == fab.engine.total_chips


PREEMPT_JOBS = [
    Job("train-low", "mpi-compute", 6, 300.0, arrival=0.0, priority=0,
        workload="train"),
    Job("serve-0", "omp", 2, 120.0, arrival=0.0, priority=1,
        workload="serve"),
    Job("train-hi", "mpi-compute", 6, 150.0, arrival=3.0, priority=5,
        workload="train"),
]


def test_sharded_fabric_run_trace_matches_prediction():
    fab = _fabric(shard_hosts=2)
    assert isinstance(fab.engine, ShardedPlacementEngine)
    assert fab.engine.n_shards == 2
    pred = fab.predict_trace(PREEMPT_JOBS, preempt=True)
    assert pred.preemptions >= 1
    ex = fab.run_trace(PREEMPT_JOBS, _factory(), preempt=True)
    assert ex.result.finish_order == pred.finish_order
    assert ex.result.preemptions == pred.preemptions
    assert fab.idle_chips() == fab.engine.total_chips
    one = _fabric(shard_hosts=4)
    central = _fabric()
    assert one.predict_trace(PREEMPT_JOBS, preempt=True).actions == \
        central.predict_trace(PREEMPT_JOBS, preempt=True).actions


def test_fleet_churn_hard_fail_resumes_bit_exact_live():
    jobs = [Job("train-a", "mpi-compute", 4, 200.0, arrival=0.0,
                workload="train"),
            Job("serve-0", "omp", 2, 120.0, arrival=0.0, priority=1,
                workload="serve")]
    devs = virtual_devices(8, "cpu")
    events = [FleetEvent(6.0, "fail", hosts=[0]),
              FleetEvent(10.0, "join", capacities=[2])]
    for shard_hosts in (None, 2):
        fab = Fabric(devices=devs[:6], chips_per_host=2,
                     shard_hosts=shard_hosts, spares=devs[6:])
        pred = fab.predict_trace(jobs, preempt=True, fleet_events=events,
                                 checkpoint_interval=4.0)
        assert pred.recoveries >= 1, pred.recoveries
        ex = fab.run_trace(jobs, _factory(), preempt=True,
                           fleet_events=events, checkpoint_interval=4.0)
        res = ex.result
        assert res.actions == pred.actions
        assert res.recoveries == pred.recoveries >= 1
        assert res.finish_order == pred.finish_order
        victim = next(a.payload["job"] for a in res.actions
                      if a.kind == "recover")
        rec = ex.live[victim]
        assert rec["failures"] >= 1 and rec["checkpoints"] >= 1
        assert rec["resumes_verified"] >= 1 and rec["steps"] >= 3
        assert set(res.finish_order) == {j.job_id for j in jobs}

    # graceful reclaim: the drained gang evacuates through the planner
    small = [Job("train-a", "mpi-compute", 2, 150.0, arrival=0.0,
                 workload="train"),
             Job("serve-0", "omp", 2, 120.0, arrival=0.0, priority=1,
                 workload="serve")]
    fab = Fabric(devices=devs[:6], chips_per_host=2, spares=devs[6:])
    events = [FleetEvent(5.0, "reclaim", hosts=[2], drain_s=30.0)]
    pred = fab.predict_trace(small, preempt=True, fleet_events=events)
    ex = fab.run_trace(small, _factory(), preempt=True, fleet_events=events)
    assert ex.result.actions == pred.actions
    assert ex.result.evacuations == pred.evacuations >= 1
    assert ex.result.recoveries == 0
    moves = [m for r in ex.live.values() for m in r.get("moves", [])]
    assert moves and all(m["kind"] == "migrate" and m["bytes"] > 0
                         for m in moves)


def test_run_trace_preempts_and_matches_simulator_prediction():
    fab = _fabric()
    pred = fab.predict_trace(PREEMPT_JOBS, preempt=True)
    assert pred.preemptions >= 1
    ex = fab.run_trace(PREEMPT_JOBS, _factory(), preempt=True)
    res = ex.result
    assert res.finish_order == pred.finish_order
    assert res.preemptions == pred.preemptions >= 1
    assert ex.live["train-low"]["preemptions"] >= 1
    assert ex.live["train-low"]["resumes_verified"] >= 1
    kinds = {j: r["workload"] for j, r in ex.live.items()}
    assert kinds["serve-0"] == "ServeWorkload"
    assert kinds["train-hi"] == "TrainWorkload"
    ms = ex.job_makespans(PREEMPT_JOBS)
    assert set(ms) == {j.job_id for j in PREEMPT_JOBS}
    assert all(v > 0 for v in ms.values())
    assert res.finish_order[0] == "train-hi"
    assert fab.idle_chips() == fab.engine.total_chips
    assert not fab.gangs


def test_run_trace_delta_checkpoints_match_prediction():
    jobs = [Job("train-a", "mpi-compute", 4, 40.0, arrival=0.0,
                workload="train")]
    devs = virtual_devices(8, "cpu")
    events = [FleetEvent(6.0, "fail", hosts=[1]),
              FleetEvent(10.0, "join", capacities=[2])]
    fab = Fabric(devices=devs[:6], chips_per_host=2, spares=devs[6:])
    cm = fab.engine.cost_model
    cm.ckpt_delta_fraction = 0.1
    cm.ckpt_rebase_every = 4
    pred = fab.predict_trace(jobs, preempt=True, fleet_events=events,
                             checkpoint_interval=2.0)
    assert pred.recoveries >= 1
    ex = fab.run_trace(jobs, _factory(), preempt=True, fleet_events=events,
                       checkpoint_interval=2.0)
    res = ex.result
    assert res.actions == pred.actions
    assert res.recoveries == pred.recoveries >= 1
    rec = ex.live["train-a"]
    assert rec.get("delta_checkpoints", 0) >= 1, rec
    assert rec["ckpt_bytes"] < rec["ckpt_full_bytes"], rec
    assert rec["resumes_verified"] >= 1
    frac = cm.observed_delta_fraction()
    assert frac is not None and 0 < frac < 1.0


def test_shrink_before_rollback_live_matches_prediction():
    jobs = [Job("train-a", "mpi-compute", 4, 200.0, arrival=0.0,
                workload="train"),
            Job("serve-0", "omp", 2, 120.0, arrival=0.0, priority=1,
                workload="serve")]
    devs = virtual_devices(8, "cpu")
    events = [FleetEvent(6.0, "fail", hosts=[0]),
              FleetEvent(10.0, "join", capacities=[2])]
    fab = Fabric(devices=devs[:6], chips_per_host=2, spares=devs[6:],
                 cost_model=CostModel(risk_tau_s=4.0))
    pred = fab.predict_trace(jobs, fleet_events=events,
                             checkpoint_interval=4.0, shrink_recovery=True)
    assert pred.shrinks >= 1 and pred.regrows >= 1
    assert pred.recoveries == 0
    ex = fab.run_trace(jobs, _factory(), fleet_events=events,
                       checkpoint_interval=4.0, shrink_recovery=True)
    res = ex.result
    assert res.actions == pred.actions
    assert res.shrinks == pred.shrinks and res.regrows == pred.regrows
    assert res.recoveries == 0 and res.lost_work_s == 0.0
    assert res.finish_order == pred.finish_order
    rec = ex.live["train-a"]
    assert rec.get("shrinks", 0) >= 1 and rec.get("regrows", 0) >= 1
    assert rec["steps"] >= 3
    assert [m["kind"] for m in rec["moves"]] == ["shrink", "regrow"]


def test_adaptive_cadence_rederives_interval_from_observed_deltas():
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=40)
    jobs = [Job("train-a", "mpi-compute", 4, 400.0, arrival=0.0,
                workload="train")]
    cm = CostModel(ckpt_rebase_every=3)
    fab = _fabric(cost_model=cm)
    ex = fab.run_trace(jobs, workload_factory(CFG, ocfg, DCFG,
                                              train_steps=10),
                       checkpoint_interval=8.0, adapt_cadence=True)
    rec = ex.live["train-a"]
    assert rec["checkpoints"] >= 3
    frac = cm.observed_delta_fraction()
    assert frac is not None and 0.0 < frac < 1.0
    assert "adapted_interval_s" in rec, sorted(rec)
    tau = rec["adapted_interval_s"]
    assert 0.0 < tau < 8.0
    eff0 = cm.effective_checkpoint_cost_s()
    implied = eff0 * (tau / 8.0) ** 2
    assert cm.effective_checkpoint_cost_s(fraction=0.0) <= implied <= eff0


def test_fabric_hooks_rederive_tuner():
    """tests/test_collectives.py::test_fabric_hooks_rederive_tuner."""
    fab = _fabric()
    h = fab.bind("j0", fab.devices[:4], pods=2)
    tuner = fab.tuner
    assert "j0" in tuner.gangs
    base = tuner.rederivations
    assert base >= 1
    state = {"w": torch.zeros((4, 4))}
    moved = h.rescale(state, 8)
    assert tuner.rederivations > base and "j0" in tuner.gangs
    assert moved["w"] is not state["w"] and torch.equal(moved["w"],
                                                        state["w"])
    m = h.best_sync_mode(64 << 20)
    assert m in ("flat", "ring", "hierarchical", "compressed")
    assert m != "flat"
    h.release()
    assert "j0" not in tuner.gangs


def test_serve_gang_checkpoint_and_snapshot_keep_host_bookkeeping():
    """A serving state's slot bookkeeping is numpy on the host: it rides
    through a snapshot, a delta checkpoint and a move as numpy, and the
    delta chain replays to the checkpoint's fingerprint."""
    fab = _fabric()
    g = fab.allocate("s", 2)
    wl = ServeWorkload(CFG, prompt_len=8, new_tokens=4, batch=2,
                       max_len=16)
    wl.bind(g)
    wl.init_state(g)
    _steps(wl, g, 2)
    g.checkpoint(wl.state, 2)
    g.checkpoint(wl.state, 2)            # same layout: a delta, empty
    assert [s["kind"] for s in g.ckpt_stats] == ["full", "delta"]
    assert g.ckpt_stats[1]["bytes"] == 0
    snap = g.fail([])
    assert snap.fingerprint == snap_mod.fingerprint(wl.state)
    assert isinstance(snap.state["slots"]["plen"], np.ndarray)


def test_unchanged_checkpoint_keeps_the_last_snapshot():
    """A delta tick with nothing changed since the last checkpoint ships
    nothing and keeps the last snapshot's host state and fingerprint (no
    copy, no hash); a changed state is copied and hashed anew, and a
    failure after both replays the chain to the last fingerprint."""
    fab = _fabric()
    g = fab.allocate("t", 2)
    state = {"w": torch.arange(70000, dtype=torch.float32),
             "m": {"v": torch.ones((13, 7), dtype=torch.bfloat16)},
             "step": 3}
    first = g.checkpoint(state, 3)
    same = g.checkpoint(state, 3)
    assert [s["kind"] for s in g.ckpt_stats] == ["full", "delta"]
    assert g.ckpt_stats[1]["bytes"] == 0
    assert same.state is first.state
    assert same.fingerprint == first.fingerprint \
        == snap_mod.fingerprint(state)
    state["w"][5] = -1.0                 # the live leaf changes in place
    changed = g.checkpoint(state, 4)
    assert g.ckpt_stats[2]["kind"] == "delta" and g.ckpt_stats[2]["bytes"]
    assert changed.state is not first.state
    assert float(first.state["w"][5]) == 5.0
    assert changed.fingerprint == snap_mod.fingerprint(state) \
        != first.fingerprint
    snap = g.fail([])
    assert snap.fingerprint == changed.fingerprint
    assert snap_mod.fingerprint(snap.state) == changed.fingerprint


# ---------------------------------------------------------------------------
# tests/test_dist.py on the port runtime
# ---------------------------------------------------------------------------
DIST_CFG = reduced_config("llama3.2-1b").with_(n_layers=2, vocab=128)
DIST_DCFG = DataConfig(vocab=128, seq_len=16, global_batch=8)


def test_runtime_elastic_rescale_loss_invariant(tmp_path):
    base = FaabricTrainRuntime(DIST_CFG, OCFG, DIST_DCFG, RuntimeConfig(
        total_steps=8, checkpoint_every=100, ckpt_dir=str(tmp_path / "a")),
        ranks=8, device="cpu").run(seed=0)[1]
    el = FaabricTrainRuntime(DIST_CFG, OCFG, DIST_DCFG, RuntimeConfig(
        total_steps=8, checkpoint_every=100, ckpt_dir=str(tmp_path / "b"),
        rescale_at={4: 4}), ranks=8, device="cpu").run(seed=0)[1]
    assert el["rescales"] == 1
    assert [e["world"] for e in el["log"]] == [8] * 4 + [4] * 4
    np.testing.assert_allclose(base["losses"], el["losses"], atol=1e-5)


def test_migration_between_device_sets_bit_exact():
    devs = virtual_devices(8, "cpu")
    state = {"w": torch.arange(100000, dtype=torch.float32),
             "m": {"v": torch.ones((13, 7))}}
    fab = Fabric(devices=devs, chips_per_host=4)
    g = fab.bind("j", devs[:4])
    moved = g.evacuate(state, [(1, 4)])
    assert [d.index for d in g.devices] == [4, 5, 6, 7]
    assert migration.verify_migration(state, moved)
    assert moved["w"].data_ptr() != state["w"].data_ptr()
    last = g.epoch_log[-1]
    assert last["kind"] == "evacuate"
    assert last["bytes"] == diffsync.tree_nbytes(state)
    moved, stats = migration.migrate_via_snapshot("j", 3, state, "cpu")
    assert migration.verify_migration(state, moved)
    prior = snap_mod.take("j", 3, state)
    state2 = {"w": state["w"].clone(), "m": state["m"]}
    state2["w"][5] += 1.0
    moved2, stats2 = migration.migrate_via_snapshot("j", 4, state2, "cpu",
                                                    prior=prior)
    assert stats2["moved_bytes"] < stats2["full_bytes"] / 2
    assert migration.verify_migration(state2, moved2)


def test_straggler_triggers_live_migration(tmp_path):
    base = FaabricTrainRuntime(DIST_CFG, OCFG, DIST_DCFG, RuntimeConfig(
        total_steps=8, checkpoint_every=100, ckpt_dir=str(tmp_path / "b")),
        ranks=8, device="cpu").run(seed=0)[1]
    rt = FaabricTrainRuntime(DIST_CFG, OCFG, DIST_DCFG, RuntimeConfig(
        total_steps=8, checkpoint_every=100, ckpt_dir=str(tmp_path / "s")),
        ranks=8, device="cpu")
    det = rt.control.straggler
    for t in (1.0, 1.0, 1.0):
        assert not det.observe(t)
    fired = [det.observe(5.0) for _ in range(det.patience)]
    assert fired[-1], "EWMA straggler detector must fire"
    state = rt.init_state(seed=0)
    rt._build()
    before = [d.id for d in rt.devices]
    state = rt._migrate_gang(state)
    after = [d.id for d in rt.devices]
    assert before != after and sorted(before) == sorted(after)
    out = rt.run(seed=0, state=state)[1]
    np.testing.assert_allclose(base["losses"], out["losses"], atol=1e-5)


# ---------------------------------------------------------------------------
# One live trace in both packages
# ---------------------------------------------------------------------------
PARITY_JOBS = [("train-a", "mpi-compute", 4, 200.0, 0.0, 0, "train"),
               ("serve-0", "omp", 2, 120.0, 0.0, 1, "serve"),
               ("train-hi", "mpi-compute", 4, 100.0, 3.0, 5, "train")]
PARITY_EVENTS = [(6.0, "fail", [0]), (10.0, "join", [2])]
PARITY_CKPT = 4.0


@pytest.fixture(scope="module")
def jax_trace():
    code = textwrap.dedent(f"""
        import json, jax
        import numpy as np
        from repro.configs.registry import reduced_config
        from repro.data.pipeline import DataConfig
        from repro.optim.adamw import AdamWConfig
        from repro.core.fabric import Fabric
        from repro.core.fleet import FleetEvent
        from repro.core.simulator import Job
        from repro.runtime.gang_workloads import workload_factory
        cfg = reduced_config("llama3.2-1b").with_(n_layers=1, vocab=128)
        dcfg = DataConfig(vocab=128, seq_len=8, global_batch=8)
        ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
        jobs = [Job(i, k, n, w, arrival=a, priority=p, workload=wk)
                for i, k, n, w, a, p, wk in {PARITY_JOBS!r}]
        events = [FleetEvent(t, kind, **({{"hosts": x}} if kind == "fail"
                                          else {{"capacities": x}}))
                  for t, kind, x in {PARITY_EVENTS!r}]
        devs = jax.devices()
        fab = Fabric(devices=devs[:6], chips_per_host=2, spares=devs[6:])
        pred = fab.predict_trace(jobs, preempt=True, fleet_events=events,
                                 checkpoint_interval={PARITY_CKPT})
        made = {{}}
        base = workload_factory(cfg, ocfg, dcfg, train_steps=3,
                                serve_tokens=3)
        def factory(job):
            made[job.job_id] = base(job)
            return made[job.job_id]
        ex = fab.run_trace(jobs, factory, preempt=True,
                           fleet_events=events,
                           checkpoint_interval={PARITY_CKPT})
        out = {{"pred": [a.to_dict() for a in pred.actions],
                "live": [a.to_dict() for a in ex.result.actions],
                "pred_order": pred.finish_order,
                "live_order": ex.result.finish_order,
                "losses": {{j: wl.losses for j, wl in made.items()
                            if hasattr(wl, "losses")}},
                "outs": {{j: [list(map(int, r.out)) for r in wl.requests]
                          for j, wl in made.items()
                          if hasattr(wl, "requests")}}}}
        print(json.dumps(out))
    """)
    env = {**os.environ, "PYTHONPATH": SRC,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _jax_inputs():
    """The JAX workloads' inputs as the port takes them: the seed-0 train
    state, the serve weights of seed priority + 1, and the batches."""
    jcfg = jreg.reduced_config("llama3.2-1b").with_(n_layers=1, vocab=128)
    jocfg = JAW.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    state = jax.tree.map(np.asarray, JM.init_train_state(
        jax.random.PRNGKey(0), jcfg, jocfg))

    def serve_params(seed):
        p = jax.jit(lambda k: JT.init_params(k, jcfg))(
            jax.random.PRNGKey(seed))
        return params_from_numpy(jax.tree.map(np.asarray, p), "cpu")

    def batch_fn(dcfg, step):
        jd = JD.DataConfig(vocab=dcfg.vocab, seq_len=dcfg.seq_len,
                           global_batch=dcfg.global_batch, seed=dcfg.seed)
        return {k: np.array(v) for k, v in JD.make_batch(jd, step).items()}
    return state, serve_params, batch_fn


def test_live_trace_matches_the_jax_package(jax_trace):
    state, serve_params, batch_fn = _jax_inputs()
    made = {}

    def factory(job):
        if job.workload == "serve":
            wl = ServeWorkload(CFG, new_tokens=3, prompt_len=8, batch=2,
                               max_len=12, seed=job.priority + 1,
                               params=serve_params(job.priority + 1))
        else:
            wl = TrainWorkload(CFG, OCFG, DCFG, total_steps=3,
                               init=state_from_numpy(state, "cpu"),
                               batch_fn=batch_fn)
        made[job.job_id] = wl
        return wl

    jobs = [Job(i, k, n, w, arrival=a, priority=p, workload=wk)
            for i, k, n, w, a, p, wk in PARITY_JOBS]
    events = [FleetEvent(t, kind, **({"hosts": x} if kind == "fail"
                                     else {"capacities": x}))
              for t, kind, x in PARITY_EVENTS]
    devs = virtual_devices(8, "cpu")
    fab = Fabric(devices=devs[:6], chips_per_host=2, spares=devs[6:])
    pred = fab.predict_trace(jobs, preempt=True, fleet_events=events,
                             checkpoint_interval=PARITY_CKPT)
    ex = fab.run_trace(jobs, factory, preempt=True, fleet_events=events,
                       checkpoint_interval=PARITY_CKPT)
    assert [a.to_dict() for a in pred.actions] == jax_trace["pred"]
    assert [a.to_dict() for a in ex.result.actions] == jax_trace["live"]
    assert pred.finish_order == jax_trace["pred_order"]
    assert ex.result.finish_order == jax_trace["live_order"] \
        == pred.finish_order
    assert ex.result.preemptions >= 2 and ex.result.recoveries == 1
    for job, losses in jax_trace["losses"].items():
        np.testing.assert_allclose(made[job].losses, losses, rtol=1e-5,
                                   atol=1e-5)
    # the rolled-back gang replayed its lost steps to the same losses
    failed = next(a.payload["job"] for a in ex.result.actions
                  if a.kind == "recover")
    by_step = {}
    for step, loss in made[failed].loss_log:
        by_step.setdefault(step, []).append(loss)
    assert any(len(v) > 1 for v in by_step.values())
    assert all(v == v[:1] * len(v) for v in by_step.values())
    for job, outs in jax_trace["outs"].items():
        assert [r.out for r in made[job].requests] == outs
