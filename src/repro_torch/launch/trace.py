"""Trace launcher: execute a multi-tenant arrival trace for real (the
port's CLI of ``repro.launch.trace``, plus ``--device``).

Replays an arrival-time trace — Poisson arrivals, priority classes,
preemption — through ``core.fabric.Fabric.run_trace``: real concurrent
train/serve gangs share a fabric of 8 virtual devices on one torch
device (``--device``, CUDA by default), scheduled by the same
event loop and placement engine the discrete-event simulator uses, and
the live per-job completion order is compared against the simulator's
prediction for the same trace.

``--churn`` overlays a fleet-churn regime (``core.fleet``): hosts lease
in and out mid-trace — spot reclaims drain and evacuate live gangs,
hard failures roll gangs back to their last snapshot (bit-exact
resume), and joins pull staged spare devices into the pool.  Composes
with ``--sched sharded`` (incl. ``--shard-hosts auto``) and
``--host-regime mixed-gen``.  ``--risk-aware`` adds the CostModel risk
term (placement spreads away from short-lease / flaky / blast-
correlated hosts) and shrink-before-rollback recovery; ``--adapt-
cadence`` folds measured delta-checkpoint bytes back into the live
Young/Daly interval (DESIGN.md §13).

Example:
    PYTHONPATH=src python -m repro_torch.launch.trace --jobs 6 \
        --arrival-rate 0.05 --chips-per-host 2 --seed 0 \
        --churn spot-heavy --checkpoint-interval 8 --device cpu
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.registry import reduced_config
from repro_torch.core import fleet as fleet_mod
from repro_torch.core import simulator as sim
from repro_torch.core import telemetry
from repro_torch.core.devices import virtual_devices
from repro_torch.core.fabric import Fabric
from repro_torch.core.placement import derive_capacities
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.gang_workloads import workload_factory

POOL = 8            # virtual devices (the JAX CLI's 8 forced host devices)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips-per-host", type=int, default=2)
    ap.add_argument("--policy", default="binpack",
                    choices=["binpack", "spread", "locality"])
    ap.add_argument("--arrival-rate", type=float, default=0.05)
    ap.add_argument("--arrival-regime", default="poisson",
                    choices=list(sim.ARRIVAL_REGIMES),
                    help="open-loop arrival process for the trace "
                         "(poisson, diurnal sinusoid, or on/off burst)")
    ap.add_argument("--no-preempt", action="store_true")
    ap.add_argument("--train-steps", type=int, default=3)
    ap.add_argument("--serve-tokens", type=int, default=3)
    ap.add_argument("--host-regime", default="uniform",
                    choices=["uniform", "mixed-gen"],
                    help="mixed-gen models half the hosts as an older "
                         "generation at s=0.5 (CostModel speeds)")
    ap.add_argument("--sched", default="central",
                    choices=["central", "sharded"],
                    help="scheduler architecture: one engine scanning "
                         "every host, or host-group shards with summary-"
                         "index forwarding (the Fig 11 fix)")
    ap.add_argument("--shard-hosts", default=None,
                    help="hosts per shard for --sched sharded: an int, "
                         "or 'auto' for adaptive sizing that re-balances "
                         "under churn (default: "
                         "placement.DEFAULT_SHARD_HOSTS)")
    ap.add_argument("--steal-budget", type=int, default=0,
                    help="cap on cross-shard split/escalation attempts "
                         "per queue pump (0 = unbounded)")
    ap.add_argument("--churn", default="none",
                    choices=("none",) + fleet_mod.CHURN_REGIMES,
                    help="fleet-churn regime overlaid on the trace "
                         "(core.fleet.churn_schedule)")
    ap.add_argument("--churn-rate", type=float, default=0.02,
                    help="disruptive-event rate (events/s) for the "
                         "Poisson churn regimes")
    ap.add_argument("--drain-s", type=float,
                    default=fleet_mod.DEFAULT_DRAIN_S,
                    help="drain window for lease reclaims")
    ap.add_argument("--checkpoint-interval", type=float, default=None,
                    help="periodic checkpoint cadence in virtual "
                         "seconds (default: Young/Daly from the churn "
                         "rate when churn is on, else off)")
    ap.add_argument("--ckpt-delta-fraction", type=float, default=None,
                    help="configured cost of a delta checkpoint as a "
                         "fraction of a full one (CostModel."
                         "ckpt_delta_fraction); enables delta-chain "
                         "charging and tightens the Young/Daly cadence. "
                         "Default: full-cost checkpoints")
    ap.add_argument("--ckpt-rebase-every", type=int, default=8,
                    help="full rebase every N checkpoints when delta "
                         "checkpointing is configured (bounds the "
                         "recovery replay chain)")
    ap.add_argument("--risk-aware", action="store_true",
                    help="risk-aware placement + shrink-before-rollback "
                         "(DESIGN.md §13): the CostModel risk term "
                         "steers gangs away from short-lease / flaky / "
                         "blast-correlated hosts (risk_tau_s = the "
                         "checkpoint cadence), and stranded gangs "
                         "reshard onto surviving capacity before any "
                         "checkpoint rollback")
    ap.add_argument("--adapt-cadence", action="store_true",
                    help="re-derive the live Young/Daly checkpoint "
                         "interval from measured delta bytes after each "
                         "rebase window (live only; Action logs then "
                         "diverge from the prediction by design)")
    ap.add_argument("--emit-trace", metavar="PATH", default=None,
                    help="record telemetry and write a Chrome trace-"
                         "event JSON (Perfetto-loadable) to PATH; a "
                         "metrics summary (with the predicted-vs-live "
                         "diff_traces report) lands next to it at "
                         "PATH + '.summary.json'")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the virtual devices; 'cpu' "
                         "runs without a GPU")
    args = ap.parse_args(argv)

    tel = (telemetry.enable() if args.emit_trace else telemetry.get())

    all_devices = virtual_devices(POOL, args.device)
    # churn regimes with joins draw from staged spares: generate the
    # schedule against the reduced starting fleet, hold back the devices
    # its joins will need
    fleet_events = None
    spares = []
    devices = all_devices
    hosts0 = 0
    # one horizon for the churn schedule AND the Young/Daly estimate
    horizon = max(60.0, args.jobs / max(args.arrival_rate, 1e-6))
    if args.churn != "none":
        # spares must back every join: the regimes reclaim at most half
        # the starting fleet (like-for-like rejoins), so a third of the
        # devices staged as spares always suffices
        total_hosts = max(1, len(all_devices) // args.chips_per_host)
        n_spare_hosts = min(total_hosts - 1, -(-total_hosts // 3))
        n_spare = max(0, n_spare_hosts) * args.chips_per_host
        devices = all_devices[:len(all_devices) - n_spare]
        assert devices, "fleet too small for churn spares"
        hosts0 = len(derive_capacities(len(devices),
                                       args.chips_per_host))
        fleet_events = fleet_mod.churn_schedule(
            args.churn, hosts0, args.chips_per_host, horizon,
            seed=args.seed, rate=args.churn_rate, drain_s=args.drain_s)
        # drop joins the spare pool cannot back
        budget, kept = n_spare, []
        for ev in fleet_events:
            if ev.kind == "join":
                need = sum(ev.capacities)
                if need > budget:
                    continue
                budget -= need
            kept.append(ev)
        fleet_events = kept
        spares = all_devices[len(devices):]

    speeds = None
    if args.host_regime == "mixed-gen":
        n_hosts = len(derive_capacities(len(devices),
                                        args.chips_per_host))
        speeds = sim.hetero_speeds(n_hosts)
    shard_hosts = None
    if args.sched == "sharded":
        from repro_torch.core.placement import DEFAULT_SHARD_HOSTS
        raw = args.shard_hosts
        shard_hosts = ("auto" if raw == "auto"
                       else int(raw) if raw else DEFAULT_SHARD_HOSTS)
    fabric = Fabric(devices=devices, chips_per_host=args.chips_per_host,
                    policy=args.policy, speeds=speeds,
                    shard_hosts=shard_hosts,
                    steal_budget=args.steal_budget, spares=spares)
    n_chips = fabric.engine.total_chips
    cost_model = fabric.engine.cost_model
    if args.ckpt_delta_fraction is not None:
        # delta checkpointing: both predicted and live traces charge
        # the configured fraction (Action logs stay identical), and
        # Young/Daly below consumes the cheaper amortised cost
        cost_model.ckpt_delta_fraction = args.ckpt_delta_fraction
        cost_model.ckpt_rebase_every = max(1, args.ckpt_rebase_every)
    ckpt_interval = args.checkpoint_interval
    if ckpt_interval is None and fleet_events:
        mtbf = fleet_mod.churn_mtbf(fleet_events, horizon, hosts=hosts0)
        tau = fleet_mod.optimal_checkpoint_interval(
            mtbf, cost_model=cost_model)
        ckpt_interval = None if tau == float("inf") else tau
    if args.risk_aware:
        # the risk term's expected-lost-work scale is the gang
        # checkpoint cadence; with no cadence a failure forfeits the
        # run, so the horizon stands in
        cost_model.risk_tau_s = (ckpt_interval if ckpt_interval
                                 is not None else horizon)
    # mixed train/serve trace sized to the local fabric, two priority
    # classes (9:1 high) — the §2.1 shared-cluster economics, live
    jobs = sim.mixed_trace(args.jobs, seed=args.seed,
                           chips_per_host=args.chips_per_host,
                           arrival_rate=args.arrival_rate,
                           priority_classes=[(0, 0.9), (5, 0.1)],
                           arrival_regime=args.arrival_regime)
    # under churn, cap gang sizes at half the starting fleet (the churn
    # generator never touches more than half the hosts, so every job
    # stays schedulable through the deepest reclaim trough)
    cap = n_chips if args.churn == "none" else max(2, n_chips // 2)
    for job in jobs:
        job.parallelism = max(2, min(job.parallelism, cap))

    cfg = reduced_config(args.arch).with_(n_layers=1, vocab=128)
    dcfg = DataConfig(vocab=128, seq_len=8, global_batch=8,
                      seed=args.seed)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)

    preempt = not args.no_preempt
    predicted = fabric.predict_trace(jobs, preempt=preempt,
                                     fleet_events=fleet_events,
                                     checkpoint_interval=ckpt_interval,
                                     shrink_recovery=args.risk_aware)
    ex = fabric.run_trace(
        jobs, workload_factory(cfg, ocfg, dcfg,
                               train_steps=args.train_steps,
                               serve_tokens=args.serve_tokens),
        preempt=preempt, fleet_events=fleet_events,
        checkpoint_interval=ckpt_interval,
        shrink_recovery=args.risk_aware,
        adapt_cadence=args.adapt_cadence)
    live = ex.result
    diff = telemetry.diff_traces(predicted, live)
    if args.emit_trace:
        tel.write_chrome_trace(args.emit_trace)
        summary = tel.summary()
        summary["diff_traces"] = diff
        summary["observed_step_times"] = {
            f"{hk}/{jk}": {"count": n, "mean_s": mean}
            for (hk, jk), (n, mean)
            in sorted(cost_model.observed_step_times().items())}
        with open(args.emit_trace + ".summary.json", "w") as f:
            json.dump(telemetry._plain(summary), f, indent=1,
                      sort_keys=True)
    report = {
        "devices": len(fabric.devices),
        "device": str(all_devices[0].device),
        "hosts": fabric.engine.hosts,
        "sched": args.sched,
        "shard_hosts": (None if shard_hosts is None
                        else fabric.engine.hosts_per_shard),
        "steal_budget": args.steal_budget,
        "host_speeds": (None if fabric.engine.speeds is None
                        else list(fabric.engine.speeds)),
        "jobs": len(jobs),
        "arrival_regime": args.arrival_regime,
        "churn": args.churn,
        "churn_events": 0 if not fleet_events else len(fleet_events),
        "checkpoint_interval_s": (None if ckpt_interval is None
                                  else round(ckpt_interval, 2)),
        "ckpt_delta_fraction": args.ckpt_delta_fraction,
        "delta_checkpoints": sum(r.get("delta_checkpoints", 0)
                                 for r in ex.live.values()),
        "ckpt_bytes_shipped": sum(r.get("ckpt_bytes", 0)
                                  for r in ex.live.values()),
        "ckpt_bytes_full_equiv": sum(r.get("ckpt_full_bytes", 0)
                                     for r in ex.live.values()),
        "observed_delta_fraction": (
            None if cost_model.observed_delta_fraction() is None
            else round(cost_model.observed_delta_fraction(), 4)),
        "predicted_order": predicted.finish_order,
        "live_order": live.finish_order,
        "order_matches": live.finish_order == predicted.finish_order,
        "diff_divergences": diff["divergences"],
        "emit_trace": args.emit_trace,
        "risk_aware": args.risk_aware,
        "adapt_cadence": args.adapt_cadence,
        "preemptions": live.preemptions,
        "recoveries": live.recoveries,
        "evacuations": live.evacuations,
        "shrinks": live.shrinks,
        "regrows": live.regrows,
        "lost_work_s": round(live.lost_work_s, 2),
        "virtual_makespan_s": round(live.makespan, 2),
        "per_job_makespan_s": {k: round(v, 2)
                               for k, v in ex.job_makespans(jobs).items()},
        "live_steps": {k: rec.get("steps", 0)
                       for k, rec in ex.live.items()},
        "resumes_verified": sum(r.get("resumes_verified", 0)
                                for r in ex.live.values()),
        "wall_s": round(ex.wall_s, 1)}
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
