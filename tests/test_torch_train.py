"""The port's training path against the JAX package on carried weights
(reduced llama3.2-1b, 2 layers, vocab 128, seq 16, batch 8, f32): the
f32-output product, the losses, loss and gradients, AdamW, one train step
with and without gradient accumulation, the flash-attention gradient on
the CPU path, the data pipeline and the train-state carry."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import pipeline as JD
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import adamw as JAW
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as TD
from repro_torch.kernels.flash_attention import ops as TFA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TAW
from repro_torch.weights import (params_from_numpy, params_to_numpy,
                                 state_from_numpy, state_to_numpy,
                                 tree_leaves)

torch.set_num_threads(2)   # several test workers share the cores

B, S, V = 8, 16, 128
RTOL = 1e-5


def _cfgs(remat=False):
    j = jreg.reduced_config("llama3.2-1b").with_(n_layers=2, vocab=V,
                                                 remat=remat)
    t = treg.reduced_config("llama3.2-1b").with_(n_layers=2, vocab=V,
                                                 remat=remat)
    return j, t


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, tcfg = _cfgs()
    ocfg = JAW.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    jstate = JM.init_train_state(jax.random.PRNGKey(0), jcfg, ocfg)
    dcfg = JD.DataConfig(vocab=V, seq_len=S, global_batch=B)
    jbatch = JD.make_batch(dcfg, 0)
    return jcfg, tcfg, ocfg, jstate, jbatch


def _tbatch(jbatch):
    return {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}


def _rel(t, j):
    t = t.detach().float().numpy().astype(np.float64)
    j = np.asarray(j, np.float64)
    return np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-30)


def _assert_trees_rel(tt, jt, tol=RTOL):
    jl = jax.tree.leaves(jt)
    tl = tree_leaves(tt)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape
        assert _rel(t, j) <= tol, (tuple(t.shape), _rel(t, j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_f32out_matches_jax_dot_general(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64, 96)).astype(np.float32)
    jx, jw = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, w))
    jo = jax.lax.dot_general(jx, jw, (((2,), (0,)), ((), ())),
                             preferred_element_type=jnp.float32)
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    to = TL.matmul_f32out(tx, tw)
    assert to.dtype == torch.float32 and tuple(to.shape) == jo.shape
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-4)


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 7, V)).astype(np.float32) * 3
    labels = rng.integers(0, V, size=(3, 7)).astype(np.int32)
    labels[0, :3] = -1
    j = JL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels), V)
    t = TL.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                        V)
    np.testing.assert_allclose(float(t), float(j), rtol=RTOL)


@pytest.mark.parametrize("s,chunk", [(16, 4), (16, 512), (13, 5)])
def test_fused_unembed_xent_value_and_grads_match_jax(s, chunk):
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, 64)).astype(np.float32)
    head = rng.normal(size=(64, V)).astype(np.float32) * 0.1
    labels = rng.integers(0, V, size=(2, s)).astype(np.int32)
    labels[1, -2:] = -1
    jl, (jgx, jgh) = jax.value_and_grad(
        lambda a, h: JL.fused_unembed_xent(a, h, jnp.asarray(labels),
                                           chunk), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    tl = TL.fused_unembed_xent(tx, th, torch.from_numpy(labels), chunk)
    tgx, tgh = torch.autograd.grad(tl, [tx, th])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)
    assert _rel(tgx, jgx) <= RTOL and _rel(tgh, jgh) <= RTOL
    if s % chunk == 0:       # the deploy twin scans whole chunks only
        js = JL.fused_unembed_xent_scan(jnp.asarray(x), jnp.asarray(head),
                                        jnp.asarray(labels), chunk)
        np.testing.assert_allclose(float(tl.detach()), float(js), rtol=RTOL)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax_value_and_grad(remat):
    _, _, _, jstate, jbatch = _setup()
    jcfg, tcfg = _cfgs(remat)
    (jloss, jm), jg = jax.value_and_grad(JM.make_loss_fn(jcfg),
                                         has_aux=True)(jstate["params"],
                                                       jbatch)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]),
                                "cpu")
    (tloss, tm), tg = TM.make_grad_fn(tcfg)(tparams, _tbatch(jbatch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    for k in ("loss", "xent", "aux_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                   atol=1e-7)
    assert list(tg) == list(tparams)
    _assert_trees_rel(tg, jg)


def test_adamw_matches_jax_over_three_steps():
    _, _, ocfg, jstate, _ = _setup()
    tcfg = TAW.AdamWConfig(**{f: getattr(ocfg, f) for f in
                              ocfg.__dataclass_fields__})
    rng = np.random.default_rng(3)
    jparams, jopt = jstate["params"], jstate["opt"]
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    topt = TAW.init(tparams)
    for step in range(3):
        grads = jax.tree.map(
            lambda p: rng.normal(size=p.shape).astype(np.float32)
            * (0.05 if step else 20.0), jparams)     # step 0 clips
        jparams, jopt, jom = JAW.apply(jax.tree.map(jnp.asarray, grads),
                                       jopt, jparams, ocfg)
        tparams, topt, tom = TAW.apply(params_from_numpy(grads, "cpu"),
                                       topt, tparams, tcfg)
        assert topt["step"] == int(jopt["step"]) == step + 1
        np.testing.assert_allclose(float(tom["lr"]), float(jom["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tom["grad_norm"]),
                                   float(jom["grad_norm"]), rtol=1e-6)
        for t, j in zip(tree_leaves(tparams) + tree_leaves(topt["m"])
                        + tree_leaves(topt["v"]),
                        jax.tree.leaves(jparams) + jax.tree.leaves(jopt["m"])
                        + jax.tree.leaves(jopt["v"])):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("step", [0, 1, 2, 7, 19, 25])
def test_cosine_lr_matches_jax(step):
    _, _, ocfg, _, _ = _setup()
    tcfg = TAW.AdamWConfig(**{f: getattr(ocfg, f) for f in
                              ocfg.__dataclass_fields__})
    j = JAW.cosine_lr(ocfg, jnp.asarray(step, jnp.int32))
    assert float(TAW.cosine_lr(tcfg, step)) == pytest.approx(float(j),
                                                             rel=1e-6)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(grad_accum):
    jcfg, tcfg, ocfg, jstate, jbatch = _setup()
    tocfg = TAW.AdamWConfig(**{f: getattr(ocfg, f) for f in
                               ocfg.__dataclass_fields__})
    jnew, jm = jax.jit(JM.make_train_step(jcfg, ocfg,
                                          grad_accum=grad_accum))(
        jstate, jbatch)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    tnew, tm = TM.make_train_step(tcfg, tocfg, grad_accum=grad_accum)(
        tstate, _tbatch(jbatch))
    for k in ("loss", "xent", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL)
    back = state_to_numpy(tnew)
    assert int(back["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
    _assert_trees_rel(tnew["params"], jnew["params"])
    _assert_trees_rel(tnew["opt"]["m"], jnew["opt"]["m"])
    _assert_trees_rel(tnew["opt"]["v"], jnew["opt"]["v"])


def test_train_state_round_trip():
    _, _, _, jstate, _ = _setup()
    np_state = jax.tree.map(np.asarray, jstate)
    back = state_to_numpy(state_from_numpy(np_state, "cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_state)):
        np.testing.assert_array_equal(a, b)
    assert params_to_numpy({"x": torch.ones(2)})["x"].dtype == np.float32


@pytest.mark.parametrize("s,window,blocked", [(16, 0, False), (16, 5, False),
                                              (40, 0, True), (40, 7, True)])
def test_flash_attention_cpu_gradient_matches_jax(s, window, blocked):
    rng = np.random.default_rng(s + window)
    q = rng.normal(size=(2, s, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
    w = rng.normal(size=(2, s, 4, 16)).astype(np.float32)

    def jloss(q, k, v):
        if blocked:
            out = JA.sdpa_blocked(q, k, v, window=window, block_q=16)
        else:
            out = JA.sdpa(q, k, v, causal=True, window=window)
        return jnp.sum(out * w)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = (TFA.launches, TFA.bwd_launches)
    out = TFA.flash_attention(tq, tk, tv, causal=True, window=window)
    tgrads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                 [tq, tk, tv])
    assert (TFA.launches, TFA.bwd_launches) == before   # plain path
    for t, j in zip(tgrads, jgrads):
        assert _rel(t, j) <= RTOL, _rel(t, j)


def test_make_batch_is_pure_in_seed_and_step():
    cfg = TD.DataConfig(vocab=V, seq_len=S, global_batch=B)
    a, b = TD.make_batch(cfg, 3), TD.make_batch(cfg, 3)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], TD.make_batch(cfg, 4)["tokens"])
    other = TD.make_batch(TD.DataConfig(vocab=V, seq_len=S, global_batch=B,
                                        seed=1), 3)
    assert not torch.equal(a["tokens"], other["tokens"])
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (B, S)
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].max()) < V and int(a["tokens"].min()) >= 0
    parts = [TD.shard_slice(a, r, 4) for r in range(4)]
    assert torch.equal(torch.cat([p["tokens"] for p in parts]), a["tokens"])
    assert TD.Cursor(2).advance().step == 3
    # the Zipf head dominates, as in the JAX package's distribution
    big = TD.make_batch(TD.DataConfig(vocab=V, seq_len=256,
                                      global_batch=8), 0)["tokens"]
    jbig = np.asarray(JD.make_batch(JD.DataConfig(vocab=V, seq_len=256,
                                                  global_batch=8), 0)
                      ["tokens"])
    assert abs(float((big == 0).float().mean()) - float((jbig == 0).mean())) \
        < 0.05
