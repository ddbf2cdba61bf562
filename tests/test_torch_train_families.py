"""Training the audio (whisper-small), VLM (llama-3.2-vision-11b), MoE
(granite-moe-1b-a400m), hybrid (zamba2-2.7b) and xLSTM (xlstm-1.3b)
families: the port against the JAX package on the same weights, reduced
configs, f32.  The hybrid and xLSTM families' gradients run through the
plain versions of mamba_scan and mlstm here (autograd), against
``jax.grad`` of the JAX package's jnp path (``models/ssm.py``,
``models/xlstm.py``); the sLSTM through autograd of its token loop.

- The loss and every gradient leaf of the port's ``make_grad_fn`` against
  ``jax.value_and_grad`` of the JAX loss, with and without ``remat``, on
  the JAX batch and its extras (encoder frames, image tokens).  The vision
  model's CROSS_ATTN gates are drawn from N(0, 1) (``tests/_multimodal.py``:
  at init they are 0, and the cross-attention's weights would get exactly
  zero gradient).  The MoE family runs f32 only: the JAX package trains
  MoE through its jnp path, which rounds h to the parameter dtype, a no-op
  in f32, where the port keeps h in f32 as the Pallas kernel does.
  Tolerance as tests/test_torch_train.py: each leaf's relative norm error
  at most 1e-5.
- Three steps of ``FaabricTrainRuntime`` on 2 virtual CPU ranks against
  the JAX runtime's losses (the JAX runtime in a subprocess on 2 forced CPU
  devices, as tests/test_torch_train_loop.py runs it), from the same
  state and the JAX batches with their extras; rtol 1e-5.
- The runtime's own batches carry the family's extras
  (``extra_batch_specs``), and the train CLI trains each family.
"""
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _multimodal import draw_gates
from repro.configs import registry as jreg
from repro.data import pipeline as JD
from repro.models import model as JM
from repro.optim import adamw as JAW
from repro.runtime import train_loop as JTL
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as TD
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TAW
from repro_torch.runtime import train_loop as TRL
from repro_torch.weights import (params_from_numpy, state_from_numpy,
                                 tree_leaves_with_path)

torch.set_num_threads(2)   # several test workers share the cores

ARCHS = ["whisper-small", "llama-3.2-vision-11b", "granite-moe-1b-a400m",
         "zamba2-2.7b", "xlstm-1.3b"]
B, S = 4, 16
RTOL = 1e-5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _cfgs(arch, remat=False):
    return (jreg.reduced_config(arch).with_(remat=remat),
            treg.reduced_config(arch).with_(remat=remat))


def _jax_batch(jcfg, step=0, b=B):
    dcfg = JD.DataConfig(vocab=jcfg.vocab, seq_len=S, global_batch=b)
    return JD.make_batch(dcfg, step, JTL.extra_batch_specs(jcfg, b))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(numpy train state with drawn gates, JAX batch) of a family."""
    jcfg, _ = _cfgs(arch)
    state = jax.tree.map(np.asarray, jax.jit(
        lambda k: JM.init_train_state(k, jcfg, JAW.AdamWConfig(**OPT)))(
        jax.random.PRNGKey(0)))
    draw_gates(state["params"], jcfg)
    return state, _jax_batch(jcfg)


def _rel(t, j):
    t = t.detach().float().numpy().astype(np.float64)
    j = np.asarray(j, np.float64)
    return np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-30)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_value_and_grad(arch, remat):
    jcfg, tcfg = _cfgs(arch, remat)
    state, jbatch = _setup(arch)
    jparams = jax.tree.map(jnp.asarray, state["params"])
    (jloss, jm), jg = jax.value_and_grad(JM.make_loss_fn(jcfg),
                                         has_aux=True)(jparams, jbatch)
    tparams = params_from_numpy(state["params"], "cpu")
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    assert set(tbatch) == {"tokens", "labels",
                           *TRL.extra_batch_specs(tcfg, B)}
    (tloss, tm), tg = TM.make_grad_fn(tcfg)(tparams, tbatch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    for k in ("loss", "xent", "aux_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                   atol=1e-7)
    jl = jax.tree.leaves(jg)
    tl = tree_leaves_with_path(tg)
    assert len(jl) == len(tl)
    for (path, t), j in zip(tl, jl):
        assert tuple(t.shape) == j.shape, path
        assert _rel(t, j) <= RTOL, (path, _rel(t, j))
        # every leaf learns: the encoder's, the drawn-gate cross-attention's
        # and every expert's weights included
        assert float(np.abs(np.asarray(j)).max()) > 0, path


@pytest.mark.parametrize("arch", ARCHS)
def test_extra_batch_specs_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jspec = JTL.extra_batch_specs(jcfg, 6)
    tspec = TRL.extra_batch_specs(tcfg, 6)
    assert list(tspec) == list(jspec)
    for name, (shape, dtype) in tspec.items():
        assert tuple(shape) == jspec[name].shape
        assert str(dtype).split(".")[-1] == jspec[name].dtype.name
    batch = TD.make_batch(TD.DataConfig(vocab=tcfg.vocab, seq_len=S,
                                        global_batch=6), 0, tspec)
    for name, (shape, dtype) in tspec.items():
        assert tuple(batch[name].shape) == tuple(shape)
        assert batch[name].dtype == dtype


@pytest.fixture(scope="module")
def jax_runtime_losses(tmp_path_factory):
    """The JAX runtime's losses: STEPS steps of each family on 2 forced
    CPU devices, from the state of ``_setup`` (drawn gates), the JAX
    batches with their extras."""
    ckpt = tmp_path_factory.mktemp("jax_ckpt")
    code = textwrap.dedent(f"""
        import json
        import jax
        import numpy as np
        from repro.configs.registry import reduced_config
        from repro.data.pipeline import DataConfig
        from repro.models import model as M
        from repro.optim.adamw import AdamWConfig
        from repro.runtime.train_loop import (FaabricTrainRuntime,
                                              RuntimeConfig)
        import sys
        sys.path.insert(0, {os.path.dirname(__file__)!r})
        from _multimodal import draw_gates
        out = {{}}
        for arch in {ARCHS!r}:
            cfg = reduced_config(arch)
            ocfg = AdamWConfig(**{OPT!r})
            state = jax.tree.map(np.asarray, jax.jit(
                lambda k: M.init_train_state(k, cfg, ocfg))(
                jax.random.PRNGKey(0)))
            draw_gates(state["params"], cfg)
            state = jax.tree.map(jax.numpy.asarray, state)
            rt = RuntimeConfig(total_steps={STEPS}, checkpoint_every=100,
                               ckpt_dir={str(ckpt)!r} + "/" + arch)
            dcfg = DataConfig(vocab=cfg.vocab, seq_len={S},
                              global_batch={B})
            out[arch] = FaabricTrainRuntime(cfg, ocfg, dcfg, rt).run(
                state=state)[1]["losses"]
        print(json.dumps(out))
    """)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_runtime_losses_match_jax_runtime(jax_runtime_losses, arch,
                                          tmp_path):
    jcfg, tcfg = _cfgs(arch)
    state, _ = _setup(arch)
    tstate = state_from_numpy(state, "cpu")

    def jax_batch(_dcfg, step):
        return {k: np.array(v) for k, v in _jax_batch(jcfg, step).items()}

    rt = TRL.RuntimeConfig(total_steps=STEPS, checkpoint_every=0,
                           ckpt_dir=str(tmp_path))
    runtime = TRL.FaabricTrainRuntime(
        tcfg, TAW.AdamWConfig(**OPT),
        TD.DataConfig(vocab=tcfg.vocab, seq_len=S, global_batch=B), rt,
        ranks=2, device="cpu")
    _, out = runtime.run(state=tstate, batch_fn=jax_batch)
    assert [e["world"] for e in out["log"]] == [2] * STEPS
    np.testing.assert_allclose(out["losses"], jax_runtime_losses[arch],
                               rtol=RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_runtime_draws_the_extras_and_the_cli_trains(arch, tmp_path,
                                                      capsys):
    """The runtime's own batches carry the family's extras (the model
    reads them: a batch without them fails), and ``launch.train`` trains
    the family on the CPU with them."""
    _, tcfg = _cfgs(arch)
    dcfg = TD.DataConfig(vocab=tcfg.vocab, seq_len=S, global_batch=B)
    seen = []

    def spy(d, step):
        batch = TRL.family_batch_fn(tcfg)(d, step)
        seen.append(sorted(batch))
        return batch

    rt = TRL.RuntimeConfig(total_steps=2, checkpoint_every=0,
                           ckpt_dir=str(tmp_path / "rt"))
    runtime = TRL.FaabricTrainRuntime(tcfg, TAW.AdamWConfig(**OPT), dcfg,
                                      rt, ranks=2, device="cpu")
    _, out = runtime.run(seed=0)
    _, spied = TRL.FaabricTrainRuntime(
        tcfg, TAW.AdamWConfig(**OPT), dcfg,
        TRL.RuntimeConfig(total_steps=2, checkpoint_every=0,
                          ckpt_dir=str(tmp_path / "spy")),
        ranks=2, device="cpu").run(seed=0, batch_fn=spy)
    assert out["losses"] == spied["losses"]      # the default batches
    assert seen == [sorted({"tokens", "labels",
                            *TRL.extra_batch_specs(tcfg, B)})] * 2
    if tcfg.family in ("audio", "vlm"):
        bare = lambda d, s: TD.make_batch(d, s)          # noqa: E731
        with pytest.raises(KeyError):
            TRL.FaabricTrainRuntime(
                tcfg, TAW.AdamWConfig(**OPT), dcfg,
                TRL.RuntimeConfig(total_steps=1, checkpoint_every=0,
                                  ckpt_dir=str(tmp_path / "bare")),
                device="cpu").run(seed=0, batch_fn=bare)
    capsys.readouterr()
    cli = tlaunch.main(["--arch", arch, "--reduced", "--steps", "3",
                        "--ranks", "2", "--global-batch", "4", "--seq-len",
                        "16", "--device", "cpu", "--checkpoint-every", "0",
                        "--ckpt-dir", str(tmp_path / "cli")])
    printed = capsys.readouterr().out
    assert len(cli["losses"]) == 3 and np.isfinite(cli["losses"]).all()
    assert f"arch={arch} ranks=2" in printed


@pytest.mark.parametrize("arch", ARCHS)
def test_gang_workload_batches_carry_the_extras(arch):
    """A Fabric train gang's default batches carry the family's extras,
    as the JAX package's TrainWorkload draws them."""
    from repro_torch.runtime.gang_workloads import TrainWorkload
    _, tcfg = _cfgs(arch)
    dcfg = TD.DataConfig(vocab=tcfg.vocab, seq_len=S, global_batch=B)
    batch = TrainWorkload(tcfg, TAW.AdamWConfig(**OPT), dcfg).batch_fn(dcfg,
                                                                       0)
    assert set(batch) == {"tokens", "labels",
                          *TRL.extra_batch_specs(tcfg, B)}
