"""The port's snapshots, checkpoint manager, migration and control points
against the JAX package's, on the same numpy states: fingerprints of a
carried train state, the manager's stats (bytes, full bytes, kind,
incremental) and restores over full, incremental and delta-chain saves
(mirroring tests/test_substrate.py and tests/test_delta_checkpoint.py),
the moved bytes of a delta migration, and the actions of the control
point runner."""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import registry as jreg
from repro.core import control as JC
from repro.core import migration as JMig
from repro.core import snapshot as JS
from repro.models import model as JM
from repro.optim import adamw as JAW
from repro_torch.checkpoint.manager import CheckpointManager as TManager
from repro_torch.core import control as TC
from repro_torch.core import migration as TMig
from repro_torch.core import snapshot as TS
from repro_torch.weights import (params_from_numpy, params_to_numpy,
                                 state_from_numpy, tree_leaves)

torch.set_num_threads(2)   # several test workers share the cores


def _t(tree):
    """A numpy state tree as the port's: tensors, and an int for a 0-d
    int32 leaf named ``step``."""
    return {k: int(v) if k == "step" else params_from_numpy(v, "cpu")
            for k, v in tree.items()}


def _leaves_equal(port_tree, jax_tree):
    for t, j in zip(tree_leaves(port_tree), jax.tree.leaves(jax_tree)):
        j = np.asarray(j)
        if isinstance(t, int):
            assert np.int32(t) == j and j.dtype == np.int32
        else:
            got = params_to_numpy(t, ml_dtypes.bfloat16)
            assert got.dtype == j.dtype and got.shape == j.shape
            np.testing.assert_array_equal(got, j)


def _train_states():
    """A reduced bf16 llama3.2-1b train state of the JAX package, as numpy
    and as the port's state (the step an int)."""
    cfg = jreg.reduced_config("llama3.2-1b").with_(n_layers=2, vocab=128,
                                                   dtype="bfloat16")
    jstate = JM.init_train_state(jax.random.PRNGKey(0), cfg,
                                 JAW.AdamWConfig())
    host = jax.tree.map(np.array, jstate)
    return jstate, host, state_from_numpy(host, "cpu")


def test_fingerprint_of_a_carried_train_state_equals_jax():
    jstate, host, tstate = _train_states()
    assert host["params"]["embed"].dtype == ml_dtypes.bfloat16
    jsnap, tsnap = JS.take("j", 3, jstate), TS.take("j", 3, tstate)
    assert tsnap.fingerprint == jsnap.fingerprint
    assert tsnap.nbytes == jsnap.nbytes
    # a step later (the step count moved, a row changed), still equal
    host["opt"]["step"] = np.int32(7)
    host["params"]["embed"][5] = 1.0
    tstate = state_from_numpy(host, "cpu")
    assert TS.take("j", 4, tstate).fingerprint == \
        JS.take("j", 4, host).fingerprint != jsnap.fingerprint


def test_snapshot_is_a_copy_and_restores_bit_exact():
    _, _, tstate = _train_states()
    snap = TS.take("j", 5, tstate)
    emb = tstate["params"]["embed"]
    emb.add_(1.0)                         # the optimizer writes in place
    assert not torch.equal(snap.state["params"]["embed"], emb)
    restored = TS.restore(snap, "cpu")
    assert restored["params"]["embed"] is not snap.state["params"]["embed"]
    assert TS.verify(snap, TS.take("j", 5, restored))
    assert restored["opt"]["step"] == 0
    if not torch.cuda.is_available():     # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            TS.restore(snap)


def test_snapshot_delta_chain():
    state = {"w": torch.zeros(5000)}
    snap = TS.take("j", 0, state)
    s1 = {"w": state["w"].clone()}
    s1["w"][17] = 1.0
    snap1 = TS.apply_delta(snap, TS.delta(snap, s1), 1)
    assert torch.equal(snap1.state["w"], s1["w"])
    assert snap1.fingerprint != snap.fingerprint
    assert snap1.fingerprint == JS.take(
        "j", 1, {"w": s1["w"].numpy()}).fingerprint


def _run_both(tmp_path, states, **kw):
    """Save the same numpy states through both managers."""
    jm = JManager(str(tmp_path / "jax"), job_id="t", **kw)
    tm = TManager(str(tmp_path / "port"), job_id="t", **kw)
    for step, st in enumerate(states):
        jm.save(step, st, blocking=True)
        tm.save(step, _t(st), blocking=True)
    keys = ("step", "bytes", "full_bytes", "kind", "incremental")
    assert [{k: s[k] for k in keys} for s in tm.stats] == \
        [{k: s[k] for k in keys} for s in jm.stats]
    return jm, tm


def test_checkpoint_full_and_incremental(tmp_path):
    """test_substrate.py's sequence: incremental every 3rd save."""
    w, states = np.zeros(40000, np.float32), []
    for step in range(5):
        w = w.copy()
        w[step] = step + 1.0
        states.append({"w": w, "step": np.int32(step)})
    jm, tm = _run_both(tmp_path, states, keep=10, incremental_every=3)
    assert [s["incremental"] for s in tm.stats] == \
        [False, True, True, False, True]
    restored, step = tm.restore(device="cpu")
    assert step == 4
    _leaves_equal(restored, states[4])
    sizes = {s["step"]: s["bytes"] for s in tm.stats}
    assert sizes[1] < sizes[0] / 2


def test_checkpoint_restore_specific_step(tmp_path):
    states = [{"w": np.full((10,), float(s), np.float32)} for s in range(3)]
    _, tm = _run_both(tmp_path, states, keep=10)
    restored, step = tm.restore(step=1, device="cpu")
    assert step == 1
    _leaves_equal(restored, states[1])
    assert tm.latest_step() == 2


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(300, 40)).astype(np.float32),
            "m": rng.normal(size=(130,)).astype(ml_dtypes.bfloat16),
            "step": np.int32(0)}


def _mutate(state, s):
    out = {k: np.array(v, copy=True) for k, v in state.items()}
    out["w"][s % 300, :5] += 1.0
    out["step"] = np.int32(s)
    return out


def test_manager_delta_chain_bit_exact(tmp_path):
    """base + deltas + rebase: the kinds follow the rebase policy, and
    every step restores bit-exactly through the chain."""
    state, states = _state(), []
    for s in range(7):
        state = _mutate(state, s)
        states.append(state)
    jm, tm = _run_both(tmp_path, states, keep=3, delta_chain=True,
                       rebase_every=3)
    assert [st["kind"] for st in tm.stats] == \
        ["full", "delta", "delta", "full", "delta", "delta", "full"]
    for s in range(7):
        restored, step = tm.restore(s, device="cpu")
        assert step == s
        _leaves_equal(restored, states[s])
        _leaves_equal(restored, jm.restore(s)[0])


def test_manager_delta_chain_detects_corruption(tmp_path):
    tm = TManager(str(tmp_path), "job", delta_chain=True, rebase_every=8)
    state = _state()
    for s in range(3):
        state = _mutate(state, s)
        tm.save(s, _t(state))
    entry = tm._manifest()[2]
    payload = torch.load(entry["path"], weights_only=False)
    payload["diffs"]["['w']"].new[0, 0] += 1.0
    torch.save(payload, entry["path"])
    with pytest.raises(RuntimeError, match="not bit-exact"):
        tm.restore(2, device="cpu")


def test_manager_delta_bytes_much_smaller_and_files_compact(tmp_path):
    state, states = _state(), []
    for s in range(6):
        state = _mutate(state, s)
        states.append(state)
    _, tm = _run_both(tmp_path, states, delta_chain=True, rebase_every=16)
    deltas = [st["bytes"] for st in tm.stats if st["kind"] == "delta"]
    full = tm.stats[0]["full_bytes"]
    assert deltas and max(deltas) * 2 < full
    # a delta file holds its dirty rows, not the snapshot they view
    sizes = {e["kind"]: (tmp_path / "port" / e["path"].split("/")[-1])
             .stat().st_size for e in tm._manifest()}
    assert sizes["delta"] * 2 < sizes["full"]


def test_manager_incremental_mode_round_trips(tmp_path):
    state, states = _state(1), []
    for s in range(5):
        state = _mutate(state, s)
        states.append(state)
    _, tm = _run_both(tmp_path, states, incremental_every=3)
    restored, step = tm.restore(4, device="cpu")
    assert step == 4
    _leaves_equal(restored, states[4])


def test_manager_async_saves_keep_their_order(tmp_path):
    tm = TManager(str(tmp_path), "job", keep=10)
    for s in range(4):
        tm.save(s, {"w": torch.full((50000,), float(s))}, blocking=False)
    tm.wait()
    assert [e["step"] for e in tm._manifest()] == [0, 1, 2, 3]
    assert tm.latest_step() == 3
    restored, step = tm.restore(device="cpu")
    assert step == 3 and bool((restored["w"] == 3.0).all())


def test_manager_gc_keeps_the_last_fulls(tmp_path):
    states = [{"w": np.full((100,), float(s), np.float32)} for s in range(5)]
    _, tm = _run_both(tmp_path, states, keep=2)
    assert [e["step"] for e in tm._manifest()] == [3, 4]
    assert len(list((tmp_path / "port").glob("*.pt"))) == 2


def test_migrate_via_snapshot_moves_what_jax_moves():
    _, host, tstate = _train_states()
    # the JAX snapshot of a numpy tree shares its arrays: give it a copy
    jprior = JS.take("job", 0, jax.tree.map(np.array, host))
    tprior = TS.take("job", 0, tstate)
    host["params"]["embed"][7:9] = 2.0
    host["opt"]["step"] = np.int32(1)
    tstate = state_from_numpy(host, "cpu")
    jnew, jst = JMig.migrate_via_snapshot("job", 1, host, prior=jprior)
    tnew, tst = TMig.migrate_via_snapshot("job", 1, tstate, "cpu",
                                          prior=tprior)
    for k in ("full_bytes", "moved_bytes", "delta", "fingerprint"):
        assert tst[k] == jst[k], k
    assert tst["moved_bytes"] < tst["full_bytes"] / 10
    assert TMig.verify_migration(tstate, tnew)
    _leaves_equal(tnew, jnew)
    full, fst = TMig.migrate_via_snapshot("job", 1, tstate, "cpu")
    assert fst["moved_bytes"] == fst["full_bytes"] == tst["full_bytes"]
    live = TMig.migrate_live(tstate, "cpu")
    assert TMig.verify_migration(full, live)


def test_control_points_match_jax():
    times = [1.0, 1.0, 1.1, 5.0, 5.0, 5.0, 1.0, 0.9, 6.0, 6.0, 6.0, 1.0]
    fails = {7}
    runners = []
    for mod in (JC, TC):
        step = {"n": 0}
        r = mod.ControlPointRunner(
            checkpoint_every=3,
            straggler=mod.EwmaStragglerDetector(patience=2),
            failure_probe=lambda s=step: s["n"] in fails)
        for i, t in enumerate(times):
            step["n"] = i
            r.on_step(i + 1, t, 4)
        runners.append(r)
    jr, tr = runners
    assert [a.to_dict() for a in tr.history] == \
        [a.to_dict() for a in jr.history]
    kinds = [a.kind for a in tr.history]
    assert {"checkpoint", "migrate", "recover"} <= set(kinds)
    assert tr.straggler_migrations == jr.straggler_migrations > 0
    assert TC.Action.from_dict(tr.history[0].to_dict()).kind == kinds[0]
