"""The port's gang runtime against the JAX package's FaabricTrainRuntime:
5 steps of reduced llama3.2-1b (2 layers, vocab 128, seq 16, batch 8) on
4 ranks in 2 pods, hierarchical and compressed sync, from the JAX init
and the JAX batches; and 10 steps with a checkpoint every 4 and a failure
at step 6 (tests/test_dist.py::test_runtime_failure_recovery_bit_exact).
The JAX runtime runs in a subprocess that forces 4 CPU devices (as
tests/test_dist.py does).  Also: every RuntimeConfig field is taken and
the untrained families raise, a straggler's migrate moves the gang, and
the CLI runs (and rescales) on the CPU."""
import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import pipeline as JD
from repro.models import model as JM
from repro.optim import adamw as JAW
from repro_torch.configs import registry as treg
from repro_torch.core import diffsync
from repro_torch.data import pipeline as TD
from repro_torch.launch import train as tlaunch
from repro_torch.optim import adamw as TAW
from repro_torch.runtime import train_loop as TRL
from repro_torch.weights import state_from_numpy, tree_leaves

torch.set_num_threads(2)   # several test workers share the cores

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STEPS, B, S, V = 5, 8, 16, 128
MODES = [("hierarchical", 0.05), ("compressed", 0.05), ("compressed", 1.0)]
# recovery runs: (mode, frac, failures); checkpoint every 4 of 10 steps
REC = [("hierarchical", 0.05, {}), ("hierarchical", 0.05, {6: "x"}),
       ("compressed", 0.05, {}), ("compressed", 0.05, {6: "x"})]


@pytest.fixture(scope="module")
def jax_losses(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    code = textwrap.dedent(f"""
        import json
        from repro.configs.registry import reduced_config
        from repro.data.pipeline import DataConfig
        from repro.optim.adamw import AdamWConfig
        from repro.runtime.train_loop import (FaabricTrainRuntime,
                                              RuntimeConfig)
        cfg = reduced_config("llama3.2-1b").with_(n_layers=2, vocab={V})
        dcfg = DataConfig(vocab={V}, seq_len={S}, global_batch={B})
        ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
        out = {{}}
        for i, (mode, frac) in enumerate({MODES!r}):
            rt = RuntimeConfig(total_steps={STEPS}, checkpoint_every=100,
                               pods=2, sync_mode=mode, compress_frac=frac,
                               ckpt_dir={str(ckpt)!r} + "/" + str(i))
            out[mode + str(frac)] = FaabricTrainRuntime(
                cfg, ocfg, dcfg, rt).run(seed=0)[1]["losses"]
        for i, (mode, frac, fail) in enumerate({REC!r}):
            rt = RuntimeConfig(total_steps=10, checkpoint_every=4, pods=2,
                               sync_mode=mode, compress_frac=frac,
                               inject_failures=dict(fail),
                               ckpt_dir={str(ckpt)!r} + "/r" + str(i))
            rep = FaabricTrainRuntime(cfg, ocfg, dcfg, rt).run(seed=0)[1]
            out["rec" + str(i)] = rep["losses"] + [rep["recoveries"]]
        print(json.dumps(out))
    """)
    env = {**os.environ, "PYTHONPATH": SRC,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _port_run(mode, frac, ckpt_dir, steps=STEPS, **kw):
    jcfg = jreg.reduced_config("llama3.2-1b").with_(n_layers=2, vocab=V)
    tcfg = treg.reduced_config("llama3.2-1b").with_(n_layers=2, vocab=V)
    jocfg = JAW.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    tocfg = TAW.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    jstate = JM.init_train_state(jax.random.PRNGKey(0), jcfg, jocfg)
    state = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jdcfg = JD.DataConfig(vocab=V, seq_len=S, global_batch=B)

    def jax_batch(_cfg, step):
        return {k: np.array(v) for k, v in JD.make_batch(jdcfg, step).items()}

    rt = TRL.RuntimeConfig(total_steps=steps, pods=2, sync_mode=mode,
                           compress_frac=frac, ckpt_dir=str(ckpt_dir),
                           **{"checkpoint_every": 0, **kw})
    runtime = TRL.FaabricTrainRuntime(
        tcfg, tocfg, TD.DataConfig(vocab=V, seq_len=S, global_batch=B), rt,
        ranks=4, device="cpu")
    state, out = runtime.run(state=state, batch_fn=jax_batch)
    out["runtime"] = runtime
    return state, out


@pytest.mark.parametrize("mode,frac", MODES)
def test_runtime_losses_match_jax(jax_losses, mode, frac, tmp_path):
    _, out = _port_run(mode, frac, tmp_path)
    assert set(out) - {"runtime"} == {"losses", "recoveries", "rescales",
                                      "migrations", "straggler_migrations",
                                      "log"}
    assert [e["world"] for e in out["log"]] == [4] * STEPS
    np.testing.assert_allclose(out["losses"], jax_losses[mode + str(frac)],
                               rtol=1e-5, atol=1e-5)


def test_runtime_compressed_frac_one_is_bit_exact_to_hierarchical(tmp_path):
    hier = _port_run("hierarchical", 0.05, tmp_path / "h", steps=3)
    comp = _port_run("compressed", 1.0, tmp_path / "c", steps=3)
    assert hier[1]["losses"] == comp[1]["losses"]


def _recovery(mode, frac, tmp_path, **kw):
    base = _port_run(mode, frac, tmp_path / "base", steps=10,
                     checkpoint_every=4, **kw)
    failed = _port_run(mode, frac, tmp_path / "failed", steps=10,
                       checkpoint_every=4, inject_failures={6: "x"}, **kw)
    return base, failed


@pytest.mark.parametrize("mode,frac", [("hierarchical", 0.05),
                                       ("compressed", 1.0)])
def test_runtime_failure_recovery_bit_exact(jax_losses, mode, frac,
                                            tmp_path):
    """A failure at step 6 restores the step-4 checkpoint and replays
    steps 4-9: the losses equal the uninterrupted run's exactly, and the
    JAX runtime's recovered run within the file's tolerance.  (At frac
    1.0 every element is sent, so the residual the recovery resets is
    zero anyway.)"""
    (sb, base), (sf, failed) = _recovery(mode, frac, tmp_path)
    assert base["recoveries"] == 0 and failed["recoveries"] == 1
    assert failed["losses"] == base["losses"]
    assert len(failed["log"]) == 12       # steps 4 and 5 ran twice
    jrec = jax_losses["rec1"]
    assert jrec[-1] == 1
    np.testing.assert_allclose(failed["losses"], jrec[:-1], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(base["losses"], jax_losses["rec0"][:-1],
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(tree_leaves(sb), tree_leaves(sf)):
        assert a == b if isinstance(a, int) else torch.equal(a, b)
    kinds = [s["kind"] for s in failed["runtime"].ckpt.stats]
    steps = [s["step"] for s in failed["runtime"].ckpt.stats]
    assert kinds == ["full"] * 3 and steps == [0, 4, 8]


def test_runtime_compressed_recovery_resets_the_residual_like_jax(
        jax_losses, tmp_path):
    """Reference fact: recovery resets the error-feedback residual (the
    checkpoint holds params and optimizer only), so with compressed sync
    at frac < 1 the replayed steps after the restored one differ from
    the uninterrupted run, in the JAX runtime as in the port."""
    (_, base), (_, failed) = _recovery("compressed", 0.05, tmp_path)
    assert failed["recoveries"] == 1
    assert failed["losses"][:5] == base["losses"][:5]
    assert failed["losses"][5:] != base["losses"][5:]
    jbase, jfail = jax_losses["rec2"], jax_losses["rec3"]
    assert jfail[5:-1] != jbase[5:-1]
    np.testing.assert_allclose(base["losses"], jbase[:-1], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(failed["losses"], jfail[:-1], rtol=1e-5,
                               atol=1e-5)


def test_runtime_incremental_checkpoints_recover(tmp_path):
    (_, base), (_, failed) = _recovery("hierarchical", 0.05, tmp_path,
                                       incremental_ckpt_every=2)
    assert failed["recoveries"] == 1
    assert failed["losses"] == base["losses"]
    stats = failed["runtime"].ckpt.stats
    assert [s["kind"] for s in stats] == ["full", "diff", "full"]
    assert all(s["incremental"] == (s["kind"] == "diff") for s in stats)


def test_runtime_straggler_migrate_is_recorded_only(tmp_path):
    """A straggler's migrate action is kept in the control history and,
    since the port has a fabric, moves the gang through its handle: the
    one-rank gang rotates onto itself, and its state is copied each time
    (the bytes of the whole state), with the losses unchanged."""
    class AlwaysSlow:
        def observe(self, step_time):
            return True
    cfg = treg.reduced_config("llama3.2-1b").with_(n_layers=2, vocab=V)

    def run(slow, path):
        rt = TRL.RuntimeConfig(total_steps=3, checkpoint_every=2,
                               ckpt_dir=str(path))
        runtime = TRL.FaabricTrainRuntime(
            cfg, TAW.AdamWConfig(), TD.DataConfig(vocab=V, seq_len=S,
                                                  global_batch=B), rt,
            device="cpu")
        if slow:
            runtime.control.straggler = AlwaysSlow()
        state, out = runtime.run(seed=0)
        return runtime, state, out
    runtime, state, out = run(True, tmp_path / "slow")
    kinds = [a.kind for a in runtime.control.history]
    assert kinds == ["migrate", "checkpoint", "migrate", "migrate"]
    assert out["migrations"] == out["straggler_migrations"] == 3
    assert [s["step"] for s in runtime.ckpt.stats] == [0, 2]
    moves = [e for e in runtime.handle.epoch_log if e["kind"] == "migrate"]
    nbytes = sum(diffsync.as_tensor(x).nbytes for x in tree_leaves(state))
    assert [m["bytes"] for m in moves] == [nbytes] * 3
    assert all(m["seconds"] >= 0 for m in moves)
    _, _, base = run(False, tmp_path / "base")
    assert out["losses"] == base["losses"]


@pytest.mark.parametrize("field,value", [
    ("rescale_at", {2: 4}),
    ("elastic", object()), ("sync_mode", "auto"),
    ("placement_policy", "spread"), ("chips_per_host", 8),
    ("job_kind", "omp")])
def test_unported_fields_raise(field, value, tmp_path):
    """Every RuntimeConfig field is ported since the fabric slice: the
    runtime takes each of these.  What stays unported, whatever the
    fields, is training the MoE, hybrid, xLSTM, audio and VLM families."""
    kw = {"checkpoint_every": 0, "ckpt_dir": str(tmp_path), field: value}
    rt = TRL.RuntimeConfig(**kw)
    runtime = TRL.FaabricTrainRuntime(
        treg.reduced_config("llama3.2-1b"), TAW.AdamWConfig(),
        TD.DataConfig(), rt, device="cpu")
    assert getattr(runtime.rt, field) is value
    for arch in ("granite-moe-1b-a400m", "zamba2-2.7b", "xlstm-1.3b",
                 "whisper-small", "llama-3.2-vision-11b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TRL.FaabricTrainRuntime(treg.reduced_config(arch),
                                    TAW.AdamWConfig(), TD.DataConfig(), rt,
                                    device="cpu")


def test_runtime_rejects_bad_gangs():
    cfg = treg.reduced_config("llama3.2-1b")  # refused before any file
    mk = lambda rt, ranks: TRL.FaabricTrainRuntime(  # noqa: E731
        cfg, TAW.AdamWConfig(), TD.DataConfig(), rt, ranks=ranks,
        device="cpu")
    with pytest.raises(ValueError, match="pods"):
        mk(TRL.RuntimeConfig(checkpoint_every=0, pods=2), 3)
    with pytest.raises(ValueError, match="compressed"):
        mk(TRL.RuntimeConfig(checkpoint_every=0, sync_mode="compressed"), 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TRL.FaabricTrainRuntime(cfg, TAW.AdamWConfig(), TD.DataConfig(),
                                    TRL.RuntimeConfig(checkpoint_every=0))
    assert TRL.params_nbytes({"a": torch.zeros(3, 4)}) == 48


def _cli(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = tlaunch.main(args)
    text = buf.getvalue()
    return out, text, json.loads(text[text.index("\n{") + 1:])


def test_cli_trains_on_the_cpu(tmp_path):
    out, text, report = _cli(["--arch", "llama3.2-1b", "--reduced", "--ranks",
                              "4", "--pods", "2", "--sync", "compressed",
                              "--steps", "12", "--seq-len", "32",
                              "--device", "cpu", "--ckpt-dir",
                              str(tmp_path)])
    assert "ranks=4 mesh={'pod': 2, 'data': 2} sync=compressed" in text
    assert report["steps"] == 12 and report["recoveries"] == 0
    assert report["last_loss"] < report["first_loss"]
    assert len(out["losses"]) == 12
    out, _, report = _cli(["--arch", "llama3.2-1b", "--reduced", "--device",
                           "cpu", "--ranks", "4", "--rescale", "2:2",
                           "--steps", "3", "--ckpt-dir", str(tmp_path)])
    assert report["rescales"] == 1
    assert [e["world"] for e in out["log"]] == [4, 4, 2]


def test_cli_fail_at_recovers(tmp_path):
    args = ["--arch", "llama3.2-1b", "--reduced", "--steps", "6",
            "--seq-len", "32", "--device", "cpu", "--checkpoint-every", "2",
            "--ckpt-dir", str(tmp_path / "a")]
    base, _, _ = _cli(args)
    failed, _, report = _cli(args[:-1] + [str(tmp_path / "b"),
                                          "--fail-at", "5"])
    assert report["recoveries"] == 1 and report["steps"] == 6
    assert failed["losses"] == base["losses"]
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == [
        "job0-00000002.full.pt", "job0-00000004.full.pt",
        "job0-00000006.full.pt", "job0-manifest.json"]


def test_cli_checkpoint_defaults_are_the_jax_clis(monkeypatch):
    """--checkpoint-every 20 and --ckpt-dir /tmp/repro-train, as in
    src/repro/launch/train.py; captured before anything is written."""
    seen = {}

    class Captured(Exception):
        pass

    def fake_runtime(cfg, ocfg, dcfg, rt, **kw):
        seen["rt"] = rt
        raise Captured

    monkeypatch.setattr(tlaunch, "FaabricTrainRuntime", fake_runtime)
    with pytest.raises(Captured):
        tlaunch.main(["--arch", "llama3.2-1b", "--reduced", "--device",
                      "cpu"])
    rt = seen["rt"]
    assert rt.checkpoint_every == 20 and rt.ckpt_dir == "/tmp/repro-train"
    assert rt.inject_failures == {}
