"""The port's control plane against the JAX package's: ``core.comms``,
``telemetry``, ``placement``, ``fleet``, ``simulator``, ``scheduler`` and
``granule`` are numpy-only, and the port keeps verbatim copies of them.

* The copies differ from the JAX files only in their import lines.
* Every case of tests/test_{placement,fleet,scheduler_simulator,risk,
  telemetry,sharded}.py, and the pure comms/tuner/pricing cases of
  tests/test_collectives.py, runs again against the port's copies: the
  JAX test file's source with its ``repro.core`` imports pointed at
  ``repro_torch.core``, each case collected here as
  ``test_mirror_<file>__<case>``.  Left out: test_sharded.py's
  ``test_fill_primitives_match_reference_loops``, which fails in the JAX
  package itself (the vectorized fills disagree with ``reference_loops``);
  the port pins its vectorized fills to the JAX package's instead.
* Seeded traces through both simulators give equal Action logs,
  placements, makespans and finish orders, and both CollectiveTuners the
  same analytic dispatch table.
"""
import difflib
import os
import re

import numpy as np
import pytest

import _port_mirror

from repro.core import collectives as JC
from repro.core import comms as Jcomms
from repro.core import fleet as JF
from repro.core import placement as JP
from repro.core import simulator as JS
from repro_torch.core import collectives as TC
from repro_torch.core import comms as Tcomms
from repro_torch.core import devices as TD
from repro_torch.core import fleet as TF
from repro_torch.core import placement as TP
from repro_torch.core import simulator as TS

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
# modules of core/ by name; others by their path under the package
COPIES = ("comms", "telemetry", "placement", "fleet", "simulator",
          "scheduler", "granule", "runtime/serve_fleet")


def _import_lines(text):
    return [ln for ln in text.splitlines()
            if re.match(r"\s*(from|import) repro(_torch)?\.(core|runtime)\.?",
                        ln)]


@pytest.mark.parametrize("name", COPIES)
def test_copies_differ_only_in_their_import_lines(name):
    rel = (name if "/" in name else "core/" + name) + ".py"
    with open(os.path.join(ROOT, "src", "repro", rel)) as f:
        jax_text = f.read()
    with open(os.path.join(ROOT, "src", "repro_torch", rel)) as f:
        port_text = f.read()
    assert _port_mirror.rewrite(jax_text) == port_text
    changed = [ln[2:] for ln in difflib.ndiff(jax_text.splitlines(),
                                               port_text.splitlines())
               if ln[:2] in ("+ ", "- ")]
    assert all(ln in _import_lines(jax_text + "\n" + port_text)
               for ln in changed), changed


# ---------------------------------------------------------------------------
# The JAX package's control-plane tests, case for case, on the copies
# ---------------------------------------------------------------------------
# file -> (cases to take, or None for all; cases left out)
MIRRORED = {
    "test_placement.py": (None, ()),
    "test_fleet.py": (None, ()),
    "test_scheduler_simulator.py": (None, ()),
    "test_risk.py": (None, ()),
    "test_telemetry.py": (None, ()),
    "test_sharded.py": (None, ("test_fill_primitives_match_reference_loops",)),
    "test_collectives.py": ((
        "test_topology_from_placement", "test_size_bucket_clamped_log2",
        "test_schedule_cost_orderings", "test_best_schedule_and_crossover",
        "test_tuner_dispatch_by_size_and_topology",
        "test_tuner_placement_change_rederives_all_buckets",
        "test_tuner_probe_overrides_analytic",
        "test_collective_time_prefers_balanced_splits",
        "test_collective_pricing_off_is_bit_identical",
        "test_collective_priced_policy_picks_balanced_split",
        "test_balanced_split_respects_caps"), ()),
}


_MODULES = {fname: _port_mirror.export(globals(), fname, take, skip)
            for fname, (take, skip) in MIRRORED.items()}


@pytest.mark.parametrize("fname", sorted(MIRRORED))
def test_mirror_covers_every_case(fname):
    """Every case of the mirrored file is collected here, bar the named
    exclusions (a new JAX case cannot be missed silently), and the cases
    see the port's modules, never the JAX package's."""
    take, skip = MIRRORED[fname]
    _port_mirror.check_coverage(globals(), fname, _MODULES[fname], take,
                                skip)


# ---------------------------------------------------------------------------
# Seeded traces: JAX simulator == port simulator
# ---------------------------------------------------------------------------
def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def _summary(res, jobs):
    return {"actions": [(a.kind, _plain(a.payload)) for a in res.actions],
            "finish_order": res.finish_order,
            "makespans": res.makespans(jobs), "makespan": res.makespan,
            "preemptions": res.preemptions, "migrations": res.migrations,
            "recoveries": res.recoveries, "lost": res.lost_work_s,
            "shrinks": res.shrinks, "regrows": res.regrows,
            "evacuations": res.evacuations, "idle": res.idle_samples}


def _both(make, seed, **sim_kw):
    out = []
    for S, F, P in ((JS, JF, JP), (TS, TF, TP)):
        jobs = S.mixed_trace(24, seed=seed, chips_per_host=4,
                             arrival_rate=0.2,
                             priority_classes=[(0, 0.8), (5, 0.2)])
        events = make(F)
        kw = dict(sim_kw)
        if "cost_model" in kw:
            kw["cost_model"] = P.CostModel(**kw["cost_model"])
        sim = S.Simulator(8, 4, "granular", **kw)
        out.append(_summary(sim.run(jobs, fleet_events=events), jobs))
    return out


TRACES = {
    "preempt-backfill-binpack": (lambda F: None,
                                 dict(policy="binpack", preempt=True,
                                      backfill=True, migrate=True)),
    "locality-hetero": (lambda F: None,
                        dict(policy="locality", preempt=True,
                             speeds=[0.5] * 4 + [1.0] * 4)),
    "sharded": (lambda F: None,
                dict(policy="spread", preempt=True, sched="sharded",
                     shard_hosts=2)),
    "churn-fail-join": (
        lambda F: [F.FleetEvent(30.0, "fail", hosts=[1]),
                   F.FleetEvent(60.0, "reclaim", hosts=[2], drain_s=20.0),
                   F.FleetEvent(90.0, "join", capacities=[4, 4])],
        dict(policy="binpack", preempt=True, checkpoint_interval=10.0)),
    "churn-shrink-risk": (
        lambda F: [F.FleetEvent(30.0, "fail", hosts=[0]),
                   F.FleetEvent(50.0, "join", capacities=[4])],
        dict(policy="locality", preempt=True, checkpoint_interval=10.0,
             shrink_recovery=True, cost_model=dict(risk_tau_s=10.0))),
}


@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("seed", [0, 3])
def test_seeded_traces_equal_in_both_simulators(trace, seed):
    make, kw = TRACES[trace]
    jax_run, port_run = _both(make, seed, **kw)
    assert port_run == jax_run
    assert len(jax_run["finish_order"]) == 24


def test_engine_decisions_equal_in_both_packages():
    """One random allocate/release/migrate sequence through both engines
    under each policy: the same placements and migration plans."""
    for pol in ("binpack", "spread", "locality"):
        engines = [JP.PlacementEngine(6, 4, policy=pol),
                   TP.PlacementEngine(6, 4, policy=pol)]
        rng = np.random.default_rng(11)
        held, seen = [], [[], []]
        for step in range(60):
            if held and rng.uniform() < 0.4:
                jid = held.pop(int(rng.integers(len(held))))
                for e in engines:
                    e.release(e.allocations[jid])
                continue
            n = int(rng.integers(1, 7))
            jid = f"j{step}"
            got = [e.allocate(jid, n, kind="mpi-network") for e in engines]
            assert (got[0] is None) == (got[1] is None)
            if got[0] is not None:
                held.append(jid)
            for k, (e, a) in enumerate(zip(engines, got)):
                seen[k].append(None if a is None else list(a.placement))
                seen[k].append([(j, list(p)) for j, p in e.migration_plan(
                    [e.allocations[h] for h in held])])
        assert seen[0] == seen[1]


def test_vectorized_fills_equal_the_jax_packages():
    """The port pins the vectorized fill path (test_sharded.py's loop
    parity fails in the JAX package too, and is not "fixed" here): on
    test_sharded.py's randomized inputs, each policy places exactly as
    the JAX package's vectorized path does."""
    rng = np.random.default_rng(0)
    for trial in range(400):
        hosts = int(rng.integers(1, 40))
        cap = int(rng.integers(1, 12))
        free = rng.integers(0, cap + 1, hosts)
        n = int(rng.integers(1, max(2, free.sum() + 3)))
        speeds = (rng.choice([0.5, 0.75, 1.0], hosts)
                  if trial % 3 == 0 else None)
        kind = ("omp", "mpi-network", "mpi-compute")[trial % 3]
        for name in ("BinpackPolicy", "SpreadPolicy",
                     "LocalityScoredPolicy"):
            a = getattr(JP, name)().place(
                JP.ClusterView(free.copy(), cap, np.full(hosts, cap),
                               speeds), n, kind=kind)
            b = getattr(TP, name)().place(
                TP.ClusterView(free.copy(), cap, np.full(hosts, cap),
                               speeds), n, kind=kind)
            assert a == b, (name, free.tolist(), n)
        a = JP.FixedSlicePolicy(2).place(
            JP.ClusterView(free.copy(), cap, np.full(hosts, cap), speeds),
            n, kind=kind)
        b = TP.FixedSlicePolicy(2).place(
            TP.ClusterView(free.copy(), cap, np.full(hosts, cap), speeds),
            n, kind=kind)
        assert a == b


# ---------------------------------------------------------------------------
# CollectiveTuner: the same analytic table; probes refine it
# ---------------------------------------------------------------------------
PLACEMENTS = [[(0, 8)], [(0, 4), (1, 4)], [(0, 6), (1, 1), (2, 1)],
              [(0, 2), (1, 2), (2, 2), (3, 2)], [(3, 1), (5, 1)],
              [(0, 1)]]


def test_tuner_dispatch_tables_equal_the_jax_tuners():
    jt = JC.CollectiveTuner(link=Jcomms.LinkProfile(slow_bps=1e9))
    tt = TC.CollectiveTuner(link=Tcomms.LinkProfile(slow_bps=1e9))
    for i, pl in enumerate(PLACEMENTS):
        jt.on_placement_change(f"g{i}", pl)
        tt.on_placement_change(f"g{i}", pl)
        for nbytes in (1, 1 << 12, 4 << 20, 64 << 20, 1 << 40):
            for allowed in (None, ("flat", "ring", "hierarchical")):
                assert tt.mode_for(f"g{i}", nbytes, allowed=allowed) == \
                    jt.mode_for(f"g{i}", nbytes, allowed=allowed)
            assert tt.predicted_time(pl, nbytes) == \
                jt.predicted_time(pl, nbytes)
    assert tt.table == jt.table
    assert tt.rederivations == jt.rederivations == len(PLACEMENTS)


def test_modeled_slowlink_bytes_follow_the_comms_model():
    link = Tcomms.LinkProfile()
    two = Tcomms.Topology(2, 8, 4)
    n = 4 << 20
    assert TC.modeled_slowlink_bytes(two, n, "flat", link) == \
        pytest.approx(n)
    assert TC.modeled_slowlink_bytes(two, n, "hierarchical", link) == \
        pytest.approx(n / 4)
    assert TC.modeled_slowlink_bytes(two, n, "compressed", link, 0.05) == \
        pytest.approx(2 * 0.05 * n / 4)
    one = Tcomms.Topology(1, 8, 8)
    for mode in ("flat", "ring", "hierarchical"):
        assert TC.modeled_slowlink_bytes(one, n, mode, link) == 0.0


def test_tuner_probe_refines_with_injected_times(monkeypatch):
    """``probe`` folds each schedule's measured time into the table; the
    times are injected (no wall clock): a compressed schedule measured
    slow loses its bucket to hierarchical, as in the JAX tuner."""
    tuner = TC.CollectiveTuner()
    mesh = TD.make_gang_mesh(TD.virtual_devices(8, "cpu"), 2)
    pl = [(0, 4), (1, 4)]
    nbytes = 64 << 20
    assert tuner.mode_for(pl, nbytes) == "compressed"
    fake = {"flat": 9.0, "ring": 8.0, "hierarchical": 1.0,
            "compressed": 1e3}
    calls = []

    def measured(mesh_, mode, nbytes_, frac, reps, link):
        calls.append((mesh_.pods, mesh_.data, mode))
        return {"wall_s": 0.0, "slowlink_bytes": 0,
                "effective_s": fake[mode]}
    monkeypatch.setattr(TC, "measure_schedule", measured)
    out = tuner.probe(mesh, nbytes)
    assert out == fake and [c[2] for c in calls] == list(Tcomms.MODES)
    assert all(c[:2] == (2, 4) for c in calls)
    assert tuner.mode_for(pl, nbytes) == "hierarchical"
    assert tuner.predicted_time(pl, nbytes) == 1.0
    # a one-pod mesh cannot run the compressed schedule: not probed
    calls.clear()
    tuner.probe(TD.make_gang_mesh(TD.virtual_devices(4, "cpu")), nbytes)
    assert "compressed" not in [c[2] for c in calls]


@pytest.mark.parametrize("mode", Tcomms.MODES)
def test_measure_schedule_runs_the_port_sync(mode):
    """The probe itself, on the CPU at a small size: its slow-link bytes
    are the model's and its effective time adds their transfer time."""
    mesh = TD.make_gang_mesh(TD.virtual_devices(4, "cpu"), 2)
    link = Tcomms.LinkProfile()
    m = TC.measure_schedule(mesh, mode, 1 << 14, reps=1, link=link)
    topo = Tcomms.Topology(2, 4, 2)
    slow = int(TC.modeled_slowlink_bytes(topo, (1 << 14) // 4, mode, link))
    assert m["slowlink_bytes"] == slow
    assert m["wall_s"] > 0
    assert m["effective_s"] == pytest.approx(m["wall_s"]
                                             + slow / link.slow_bps)
