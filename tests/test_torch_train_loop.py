"""The port's gang runtime against the JAX package's FaabricTrainRuntime:
5 steps of reduced llama3.2-1b (2 layers, vocab 128, seq 16, batch 8) on
4 ranks in 2 pods, hierarchical and compressed sync, from the JAX init
and the JAX batches.  The JAX runtime runs in a subprocess that forces 4
CPU devices (as tests/test_dist.py does).  Also: the fields not ported
yet raise, and the CLI runs on the CPU."""
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
from repro_torch.data import pipeline as TD
from repro_torch.launch import train as tlaunch
from repro_torch.optim import adamw as TAW
from repro_torch.runtime import train_loop as TRL
from repro_torch.weights import state_from_numpy

torch.set_num_threads(2)   # several test workers share the cores

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STEPS, B, S, V = 5, 8, 16, 128
MODES = [("hierarchical", 0.05), ("compressed", 0.05), ("compressed", 1.0)]


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
        print(json.dumps(out))
    """)
    env = {**os.environ, "PYTHONPATH": SRC,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _port_run(mode, frac, steps=STEPS):
    jcfg = jreg.reduced_config("llama3.2-1b").with_(n_layers=2, vocab=V)
    tcfg = treg.reduced_config("llama3.2-1b").with_(n_layers=2, vocab=V)
    jocfg = JAW.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    tocfg = TAW.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    jstate = JM.init_train_state(jax.random.PRNGKey(0), jcfg, jocfg)
    state = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jdcfg = JD.DataConfig(vocab=V, seq_len=S, global_batch=B)

    def jax_batch(_cfg, step):
        return {k: np.array(v) for k, v in JD.make_batch(jdcfg, step).items()}

    rt = TRL.RuntimeConfig(total_steps=steps, checkpoint_every=0, pods=2,
                           sync_mode=mode, compress_frac=frac)
    runtime = TRL.FaabricTrainRuntime(
        tcfg, tocfg, TD.DataConfig(vocab=V, seq_len=S, global_batch=B), rt,
        ranks=4, device="cpu")
    return runtime.run(state=state, batch_fn=jax_batch)


@pytest.mark.parametrize("mode,frac", MODES)
def test_runtime_losses_match_jax(jax_losses, mode, frac):
    _, out = _port_run(mode, frac)
    assert set(out) == {"losses", "recoveries", "rescales", "migrations",
                        "straggler_migrations", "log"}
    assert [e["world"] for e in out["log"]] == [4] * STEPS
    np.testing.assert_allclose(out["losses"], jax_losses[mode + str(frac)],
                               rtol=1e-5, atol=1e-5)


def test_runtime_compressed_frac_one_is_bit_exact_to_hierarchical():
    hier = _port_run("hierarchical", 0.05, steps=3)[1]["losses"]
    comp = _port_run("compressed", 1.0, steps=3)[1]["losses"]
    assert hier == comp


@pytest.mark.parametrize("field,value", [
    ("checkpoint_every", 10), ("incremental_ckpt_every", 2),
    ("inject_failures", {3: "x"}), ("rescale_at", {2: 4}),
    ("elastic", object()), ("sync_mode", "auto"),
    ("placement_policy", "spread"), ("chips_per_host", 8),
    ("job_kind", "omp")])
def test_unported_fields_raise(field, value):
    kw = {"checkpoint_every": 0, field: value}
    rt = TRL.RuntimeConfig(**kw)
    cfg = treg.reduced_config("llama3.2-1b")
    with pytest.raises(NotImplementedError, match="slice"):
        TRL.FaabricTrainRuntime(cfg, TAW.AdamWConfig(), TD.DataConfig(), rt,
                                device="cpu")


def test_runtime_rejects_bad_gangs():
    cfg = treg.reduced_config("llama3.2-1b")
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


def test_cli_trains_on_the_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = tlaunch.main(["--arch", "llama3.2-1b", "--reduced", "--ranks",
                            "4", "--pods", "2", "--sync", "compressed",
                            "--steps", "12", "--seq-len", "32",
                            "--device", "cpu"])
    text = buf.getvalue()
    assert "ranks=4 mesh={'pod': 2, 'data': 2} sync=compressed" in text
    report = json.loads(text[text.index("\n{") + 1:])
    assert report["steps"] == 12 and report["recoveries"] == 0
    assert report["last_loss"] < report["first_loss"]
    assert len(out["losses"]) == 12
    with pytest.raises(NotImplementedError, match="slice"):
        tlaunch.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
                      "--fail-at", "2", "--steps", "3"])
