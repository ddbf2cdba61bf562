"""The port's serve control against the JAX package's: the SLO autoscaler
(``ServeSLO``, ``ScaleAction``, ``ServeAutoscaler`` in
``runtime.admission``) and the virtual serve fleet
(``runtime.serve_fleet``, a verbatim copy of the JAX module bar its
import lines, which tests/test_torch_control_plane.py checks).

The ten pure cases of tests/test_serving.py (arrival regimes, the
request stream, the admission queue, the autoscaler's control law,
``decide_scaled``, the serve-SLO penalty, the virtual fleet's burst and
drain-beats-preempt runs) run again on the port: the JAX test file's
source with its imports of the copies pointed at ``repro_torch``
(``tests/_port_mirror.py``), each case collected here as
``test_mirror_serving__<case>``.  Its live cases (real models, the
fabric) have their own mirrors: tests/test_torch_serving*.py and
tests/test_torch_fabric.py.
"""
import numpy as np

import _port_mirror
from repro.core.elastic import ElasticPolicy as JElastic
from repro.core.placement import PlacementEngine as JEngine
from repro.runtime import admission as JA
from repro.runtime import serve_fleet as JF
from repro_torch.core.elastic import ElasticPolicy as TElastic
from repro_torch.core.placement import PlacementEngine as TEngine
from repro_torch.runtime import admission as TA
from repro_torch.runtime import serve_fleet as TF

PURE = ("test_arrival_regimes_deterministic_and_mean_preserving",
        "test_burst_regime_has_flash_crowds",
        "test_request_stream_payloads_independent_of_regime",
        "test_admission_queue_priority_then_fifo",
        "test_autoscaler_grow_clone_need_and_shrink",
        "test_elastic_decide_scaled_directional",
        "test_serve_slo_penalty_is_opt_in_and_gates_scoring",
        "test_score_batch_matches_score_with_serve_penalty",
        "test_fleet_sim_burst_holds_slo_and_breathes",
        "test_fleet_sim_drain_beats_preempt_at_equal_slo")
_MOD = _port_mirror.export(globals(), "test_serving.py", take=PURE)


def test_mirror_covers_the_pure_cases():
    _port_mirror.check_coverage(globals(), "test_serving.py", _MOD, PURE)


def test_autoscaler_is_exported():
    for name in ("ServeSLO", "ScaleAction", "ServeAutoscaler"):
        assert name in TA.__all__ and name in JA.__all__


def _decisions(A, Engine, Elastic):
    """One autoscaler's actions over a seeded tick sequence of queue
    depths and p99s on an 8-chip pool that a training tenant shares."""
    eng = Engine(2, 4)
    eng.allocate("train", 4)
    eng.allocate("g0", 2)
    sc = A.ServeAutoscaler(Elastic(min_world=1, max_world=8), eng,
                           slo=A.ServeSLO(target_p99_s=0.4), base_world=2,
                           cooldown_s=1.0)
    rng = np.random.default_rng(11)
    worlds = {"g0": 2}
    out = []
    for t in np.arange(0.0, 30.0, 0.5):
        depth = int(rng.integers(0, 12))
        p99 = float(rng.choice([0.05, 0.3, 0.9]))
        for a in sc.decide(float(t), depth, p99, dict(worlds)):
            out.append((float(t), a.gang_id, a.kind, a.world))
            if a.kind in ("grow", "shrink") and a.world > 0:
                worlds[a.gang_id] = a.world
    return out


def test_autoscaler_decisions_equal_the_jax_package():
    ours = _decisions(TA, TEngine, TElastic)
    assert ours == _decisions(JA, JEngine, JElastic)
    assert {k for _, _, k, _ in ours} >= {"grow", "shrink"}


def test_fleet_sim_reports_equal_the_jax_package():
    """The same burst through both fleets, with a draining training
    tenant: equal timelines, latencies and tenant accounting."""
    reps = []
    for A, F in ((JA, JF), (TA, TF)):
        sim = F.ServeFleetSim(hosts=2, chips_per_host=8,
                              slo=A.ServeSLO(target_p99_s=0.6),
                              base_world=2, max_world=8, cooldown_s=0.5,
                              control_interval_s=0.5)
        train = F.VirtualTrainTenant("t0", sim.engine, world=12,
                                     min_world=4)
        reps.append(sim.run(A.request_stream(60, 5.0, seed=3,
                                             regime="burst", vocab=64),
                            train=train, train_mode="drain"))
    j, t = reps
    assert t.timeline == j.timeline
    for key in ("finished", "token_lat_p99", "grew", "shrank",
                "peak_world", "train_progress", "train_lost_work"):
        assert getattr(t, key) == getattr(j, key), key
