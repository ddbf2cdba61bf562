"""Spot fleet end-to-end on the PyTorch port: a train+serve tenant mix
rides out a spot-reclaim wave — the serving gang drains *gracefully* off
its reclaimed host (live evacuation, zero lost requests), the training
gang loses its host to a hard failure and recovers *bit-exactly* from its
last snapshot, and a replacement host leases in from the spare pool (the
port's twin of examples/spot_fleet.py: 6 leased and 2 spare virtual
devices, reduced llama3.2-1b; on the GPU every step runs the flash
kernels).

Act 2 replays the same hard failure against a *risk-aware* fabric
(``CostModel(risk_tau_s=...)`` + ``shrink_recovery=True``): the wide
training gang that act 1 would have rolled back instead sheds the dead
host's chips, keeps training at reduced width on the survivors, and
regrows to its submitted width the moment the replacement host joins —
zero lost work, and the live Action log still matches the simulator's
prediction step for step.

Run on the GPU (the default) or on the CPU:
    PYTHONPATH=src python examples/spot_fleet_torch.py
    PYTHONPATH=src python examples/spot_fleet_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.registry import reduced_config
from repro_torch.core.devices import virtual_devices
from repro_torch.core.fabric import Fabric
from repro_torch.core.fleet import FleetEvent
from repro_torch.core.placement import CostModel
from repro_torch.core.simulator import Job
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.gang_workloads import workload_factory

CHURN = ("drain", "evacuate", "host-fail", "recover", "join", "retire")


def risk_aware_wave(devices, factory):
    """Act 2: act 1's hard failure against a risk-aware fabric on
    ``devices`` (6 leased in 3 hosts of 2, then 2 spare), its gangs made
    by ``factory``.  A 4-chip gang spans two hosts; losing one would roll
    it back to its last snapshot.  With the risk term on and
    shrink_recovery enabled it sheds the dead host instead (live reshard
    from a surviving replica), then regrows when the spare host joins.
    Returns the live run and the simulator's prediction of it."""
    fabric = Fabric(devices=devices[:6], chips_per_host=2,
                    spares=devices[6:8], cost_model=CostModel(risk_tau_s=4.0))
    jobs = [
        Job("train-wide", "mpi-compute", 4, 200.0, arrival=0.0,
            workload="train"),
        Job("serve-1", "omp", 2, 120.0, arrival=0.0, priority=1,
            workload="serve"),
    ]
    wave = [
        FleetEvent(6.0, "fail", hosts=[0]),
        FleetEvent(10.0, "join", capacities=[2]),
    ]
    kw = dict(preempt=True, fleet_events=wave, checkpoint_interval=4.0,
              shrink_recovery=True)
    predicted = fabric.predict_trace(jobs, **kw)
    return fabric.run_trace(jobs, factory, **kw), predicted


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = reduced_config("llama3.2-1b").with_(n_layers=1, vocab=128)
    dcfg = DataConfig(vocab=128, seq_len=8, global_batch=8, seed=0)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)

    devs = virtual_devices(8, args.device)
    # 3 leased hosts of 2 chips; one spare host staged for the rejoin
    fabric = Fabric(devices=devs[:6], chips_per_host=2, spares=devs[6:8])
    print(f"fabric: {fabric.engine.hosts} hosts x 2 chips, "
          f"{len(fabric.spares)} spare chips staged")

    serve_tokens = 4
    jobs = [
        Job("serve-0", "omp", 2, 150.0, arrival=0.0, priority=1,
            workload="serve"),
        Job("train-0", "mpi-compute", 2, 180.0, arrival=0.0,
            workload="train"),
    ]
    # the spot wave: the serve gang's host is lease-reclaimed with a
    # drain window (graceful), the train gang's host hard-fails with no
    # warning, and a replacement host joins from the spares
    wave = [
        FleetEvent(5.0, "reclaim", hosts=[2], drain_s=20.0),
        FleetEvent(8.0, "fail", hosts=[1]),
        FleetEvent(12.0, "join", capacities=[2]),
    ]

    predicted = fabric.predict_trace(jobs, preempt=True,
                                     fleet_events=wave,
                                     checkpoint_interval=4.0)
    ex = fabric.run_trace(
        jobs, workload_factory(cfg, ocfg, dcfg, train_steps=4,
                               serve_tokens=serve_tokens),
        preempt=True, fleet_events=wave, checkpoint_interval=4.0)
    res = ex.result

    churn = [(a.kind, a.payload.get("hosts")) for a in res.actions
             if a.kind in CHURN]
    print("churn events:", churn)
    assert res.actions == predicted.actions, \
        "live churn diverged from the simulator's prediction"
    assert res.evacuations >= 1, "serve gang should drain gracefully"
    assert res.recoveries >= 1, "train gang should recover from snapshot"
    assert set(res.finish_order) == {j.job_id for j in jobs}

    # zero lost serve requests: every request decoded its full budget,
    # and the serve gang was never rolled back
    serve = ex.live["serve-0"]
    outputs = serve["final_metrics"]["outputs"]
    assert all(len(o) == serve_tokens for o in outputs), outputs
    assert serve.get("failures", 0) == 0
    print(f"serve-0 drained gracefully: {len(outputs)} requests x "
          f"{serve_tokens} tokens, zero lost ({outputs})")

    train = ex.live["train-0"]
    assert train.get("failures", 0) >= 1
    assert train["resumes_verified"] >= 1
    print(f"train-0 survived the hard failure: "
          f"{train['failures']} failure(s), "
          f"{train['resumes_verified']} bit-exact resume(s), "
          f"final loss {train['final_metrics']['loss']:.4f}")
    print("spot wave survived: completion order", res.finish_order,
          "makespan", round(res.makespan, 1), "s ✓")

    # ---- act 2: the same failure, but risk-aware ----------------------
    ex2, predicted2 = risk_aware_wave(
        devs, workload_factory(cfg, ocfg, dcfg, train_steps=4,
                               serve_tokens=serve_tokens))
    res2 = ex2.result
    assert res2.actions == predicted2.actions, \
        "risk-aware live run diverged from the simulator's prediction"
    assert res2.shrinks >= 1, "gang should shrink onto survivors"
    assert res2.regrows >= 1, "gang should regrow when the spare joins"
    assert res2.recoveries == 0 and res2.lost_work_s == 0.0, \
        "shrink-before-rollback should make the rollback unnecessary"
    train2 = ex2.live["train-wide"]
    print(f"train-wide shrank {train2.get('shrinks', 0)}x and regrew "
          f"{train2.get('regrows', 0)}x instead of rolling back: "
          f"0.0s lost work (act 1's train-0 lost "
          f"{round(res.lost_work_s, 1)}s), final loss "
          f"{train2['final_metrics']['loss']:.4f}")
    print("risk-aware wave survived: completion order",
          res2.finish_order, "makespan", round(res2.makespan, 1),
          "s ✓")
    return {"churn": churn, "order": list(res.finish_order),
            "makespan": res.makespan, "lost_work_s": res.lost_work_s,
            "serve_outputs": outputs,
            "train_loss": train["final_metrics"]["loss"],
            "order2": list(res2.finish_order), "makespan2": res2.makespan,
            "shrinks": train2.get("shrinks", 0),
            "regrows": train2.get("regrows", 0),
            "recoveries2": res2.recoveries,
            "lost_work_s2": res2.lost_work_s,
            "train_loss2": train2["final_metrics"]["loss"]}


if __name__ == "__main__":
    main()
