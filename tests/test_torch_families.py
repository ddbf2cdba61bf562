"""The port's MoE (granite-moe-1b-a400m) and hybrid (zamba2-2.7b) models
against the JAX package on the same weights, reduced configs, f32:
forward logits, prefill logits and states, decode, prefill-then-decode,
parameter counts, the params tree with zamba2's shared block, and the
training runtime's refusal of both families.  Tolerances as the dense
model's tests (tests/test_torch_model.py): atol 1e-4 against JAX, 5e-4
between decode and the forward."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as tdp
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import train_loop as TL
from repro_torch.weights import (params_from_numpy, params_to_numpy,
                                 tree_leaves)

torch.set_num_threads(2)   # several test workers share the cores

FAMILIES = ["granite-moe-1b-a400m", "zamba2-2.7b"]
B, S = 2, 16
ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _setup(arch, cf=None):
    jcfg = jreg.reduced_config(arch)
    tcfg = treg.reduced_config(arch)
    if cf is not None:
        jcfg, tcfg = (c.with_(capacity_factor=cf) for c in (jcfg, tcfg))
    jparams = jax.jit(lambda k: JT.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S),
                                               dtype=np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_and_aux_match_jax(arch):
    jcfg, tcfg, jp, tp, tokens = _setup(arch)
    jl, jaux, _ = jax.jit(lambda p, t: JT.forward(p, t, jcfg))(
        jp, jnp.asarray(tokens))
    tl, aux, states = TT.forward(tp, torch.from_numpy(tokens), tcfg)
    assert tl.shape == (B, S, tcfg.vocab) and states is None
    _close(tl, jl)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_logits_and_states_match_jax(arch):
    jcfg, tcfg, jp, tp, tokens = _setup(arch)
    jl, jst = jax.jit(JM.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(tokens)})
    tl, tst = TM.make_prefill_step(tcfg)(tp,
                                         {"tokens": torch.from_numpy(tokens)})
    _close(tl, jl)
    assert len(tst) == len(jst) == len(tcfg.period())
    for t_s, j_s in zip(tst, jst):
        assert set(t_s) == set(j_s)
        for key in t_s:
            assert tuple(t_s[key].shape) == j_s[key].shape, key
            _close(t_s[key], j_s[key])


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_jax_and_forward(arch):
    # a capacity that drops no token, so the forward's routing (16-token
    # groups) and the decode's (2-token groups) agree
    jcfg, tcfg, jp, tp, tokens = _setup(arch, cf=8.0)
    jserve = jax.jit(JM.make_serve_step(jcfg))
    tserve = TM.make_serve_step(tcfg)
    jst = JT.init_decode_state(jcfg, B, S, jcfg.param_dtype())
    tst = TT.init_decode_state(tcfg, B, S, torch.float32, device="cpu")
    tfull, _, _ = TT.forward(tp, torch.from_numpy(tokens), tcfg)
    for t in range(S):
        pos = np.full((B, 1), t, np.int32)
        jl, jst = jserve(jp, jst, jnp.asarray(tokens[:, t:t + 1]),
                         jnp.asarray(pos))
        tl, tst = tserve(tp, tst, torch.from_numpy(tokens[:, t:t + 1]),
                         torch.from_numpy(pos))
        _close(tl, jl)
        _close(tl[:, 0], tfull[:, t], atol=5e-4)
    for t_s, j_s in zip(tst, jst):           # the carried states agree too
        for key in t_s:
            _close(t_s[key], j_s[key])


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_at_default_capacity_matches_jax(arch):
    jcfg, tcfg, jp, tp, tokens = _setup(arch)
    jserve = jax.jit(JM.make_serve_step(jcfg))
    jst = JT.init_decode_state(jcfg, B, 8, jcfg.param_dtype())
    tst = TT.init_decode_state(tcfg, B, 8, torch.float32, device="cpu")
    for t in range(8):
        pos = np.full((B, 1), t, np.int32)
        jl, jst = jserve(jp, jst, jnp.asarray(tokens[:, t:t + 1]),
                         jnp.asarray(pos))
        tl, _ = TM.make_serve_step(tcfg)(tp, tst,
                                         torch.from_numpy(tokens[:, t:t + 1]),
                                         torch.from_numpy(pos))
        _close(tl, jl)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_then_decode_matches_forward(arch):
    jcfg, tcfg, jp, tp, tokens = _setup(arch, cf=8.0)
    tt = torch.from_numpy(tokens)
    tfull, _, _ = TT.forward(tp, tt, tcfg)
    _, st = TM.make_prefill_step(tcfg)(tp, {"tokens": tt[:, :S - 1]})
    states = TT.init_decode_state(tcfg, B, S, torch.float32, device="cpu")
    for big, pre in zip(states, st):
        for key in big:
            if key in ("k", "v"):
                big[key][:, :, :S - 1] = pre[key]
            else:                       # recurrent leaves: whole
                big[key].copy_(pre[key])
    tl, _ = TM.make_serve_step(tcfg)(tp, states, tt[:, S - 1:],
                                     torch.full((B, 1), S - 1))
    _close(tl[:, 0], tfull[:, S - 1], atol=5e-4)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("reduced", [False, True])
def test_count_params_matches_jax(arch, reduced):
    get = "reduced_config" if reduced else "get_config"
    tcfg, jcfg = getattr(treg, get)(arch), getattr(jreg, get)(arch)
    for active in (False, True):
        assert TM.count_params(tcfg, active_only=active) == \
            JM.count_params(jcfg, active_only=active)
    assert tcfg.n_params() == jcfg.n_params()


def test_zamba2_tree_with_shared_block_crosses_both_ways():
    """params["blocks"] has None at the shared block's place and the block
    lives in params["shared"]; the tree round-trips bit for bit in bf16."""
    jcfg = jreg.reduced_config("zamba2-2.7b").with_(dtype="bfloat16")
    jp = jax.jit(lambda k: JT.init_params(k, jcfg))(jax.random.PRNGKey(3))
    npt = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(npt, "cpu")
    assert tp["blocks"][1] is None and "shared" in tp
    assert tp["shared"]["attn"]["wq"].dtype == torch.bfloat16
    tcfg = treg.reduced_config("zamba2-2.7b").with_(dtype="bfloat16")
    own = TT.init_params(torch.Generator().manual_seed(0), tcfg,
                         device="cpu")
    assert own["blocks"][1] is None
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [tuple(a.shape) for a in jax.tree_util.tree_leaves(npt)]
    back = params_to_numpy(tp, bf16_dtype=np.dtype(jnp.bfloat16))
    assert back["blocks"][1] is None
    flat_a = jax.tree_util.tree_leaves(npt)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_zamba2_remat_forward_and_gradient_take_the_shared_block():
    """The remat path (per-period checkpoint) and the gradient function
    accept the None slot; the shared block gets one gradient."""
    jcfg, tcfg, jp, tp, tokens = _setup("zamba2-2.7b")
    rcfg = tcfg.with_(remat=True)
    tt = torch.from_numpy(tokens)
    with torch.enable_grad():
        logits, _, _ = TT.forward(tp, tt, rcfg)
    _close(logits, jax.jit(lambda p, t: JT.forward(p, t, jcfg)[0])(
        jp, jnp.asarray(tokens)))
    batch = {"tokens": tt, "labels": torch.roll(tt, -1, 1)}
    (loss, _), grads = TM.make_grad_fn(rcfg)(tp, batch)
    assert grads["blocks"][1] is None
    assert grads["shared"]["attn"]["wq"].shape == \
        tp["shared"]["attn"]["wq"].shape
    assert bool(torch.isfinite(loss))
    assert float(grads["shared"]["attn"]["wq"].abs().sum()) > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_training_runtime_refuses_the_family(arch, tmp_path):
    cfg = treg.reduced_config(arch)
    data = tdp.DataConfig(seq_len=16, global_batch=2, vocab=cfg.vocab)
    rt = TL.RuntimeConfig(total_steps=1, ckpt_dir=str(tmp_path))
    with pytest.raises(NotImplementedError,
                       match="training of the MoE and hybrid families"):
        TL.FaabricTrainRuntime(cfg, tadamw.AdamWConfig(), data, rt,
                               device="cpu")
