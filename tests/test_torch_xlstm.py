"""The port's xLSTM blocks (``models/xlstm.py``) and the xlstm-1.3b model
against the JAX package on the same weights and inputs, reduced config,
f32: the mLSTM and sLSTM blocks' forward (y and every state leaf) and
decode, decode after a prefill against the forward, the whole model's
forward, prefill logits and states, decode, and prefill-then-decode (the
mirror of tests/test_decode_consistency.py), parameter counts, the params
tree, the training runtime's refusal, and two JAX behaviours the port
mirrors: the head-major sLSTM recurrent term and the tanh GeLU.
Tolerances: atol 1e-4 / rtol 1e-4 against JAX; decode against the
forward atol 5e-4 / rtol 1e-3, as the JAX package's consistency test."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import registry as jreg
from repro.models import model as JM
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as tdp
from repro_torch.kernels.mlstm import ops as mlstm_ops
from repro_torch.kernels.slstm.ref import slstm_cell
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import train_loop as TL
from repro_torch.weights import (params_from_numpy, params_to_numpy,
                                 tree_leaves)

torch.set_num_threads(2)   # several test workers share the cores

ARCH = "xlstm-1.3b"
TOL = dict(atol=1e-4, rtol=1e-4)
DEC_TOL = dict(atol=5e-4, rtol=1e-3)
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def _blocks(seed=0):
    """Both blocks' parameters from the JAX init, with a random skip,
    input-gate bias and norm so that every term is exercised."""
    jcfg, tcfg = jreg.reduced_config(ARCH), treg.reduced_config(ARCH)
    km, ks = jax.random.split(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    npm = jax.tree.map(np.asarray, JX.init_mlstm(km, jcfg))
    for key, scale in (("skip", 0.3), ("norm_w", 0.3), ("bi", 1.0)):
        base = 0.0 if key == "bi" else 1.0
        npm[key] = (base + rng.standard_normal(npm[key].shape) * scale
                    ).astype(np.float32)
    nps = jax.tree.map(np.asarray, JX.init_slstm(ks, jcfg))
    return (jcfg, tcfg, npm, params_from_numpy(npm, "cpu"), nps,
            params_from_numpy(nps, "cpu"))


def _x(b, length, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, length, d)).astype(np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("b,length", [(2, 16), (1, 5), (1, 200)])
def test_mlstm_forward_matches_jax(b, length):
    """200 tokens run two chunks of the port (128 + a ragged 72) against
    one of the JAX model path (1024)."""
    jcfg, tcfg, npm, tpm, _, _ = _blocks()
    x = _x(b, length, jcfg.d_model, length)
    jy, jst = jax.jit(lambda p, x: JX.mlstm_forward(p, x, jcfg))(npm, x)
    before = mlstm_ops.launches
    ty, tst = TX.mlstm_forward(tpm, torch.from_numpy(x), tcfg)
    assert mlstm_ops.launches == before   # the CPU runs the plain version
    _close(ty, jy)
    assert set(tst) == set(jst) == {"c", "n", "m", "conv"}
    for key in tst:
        assert tuple(tst[key].shape) == jst[key].shape, key
        _close(tst[key], jst[key])


def test_mlstm_forward_from_a_state_matches_jax():
    jcfg, tcfg, npm, tpm, _, _ = _blocks()
    x = _x(2, 12, jcfg.d_model, 3)
    jst = jax.jit(lambda p, x: JX.mlstm_forward(p, x, jcfg))(npm, x)[1]
    x2 = _x(2, 9, jcfg.d_model, 4)
    jy, jfin = jax.jit(lambda p, x, s: JX.mlstm_forward(p, x, jcfg, s))(
        npm, x2, jst)
    tst = {k: torch.from_numpy(np.array(a)) for k, a in jst.items()}
    ty, tfin = TX.mlstm_forward(tpm, torch.from_numpy(x2), tcfg, tst)
    _close(ty, jy)
    for key in ("c", "n", "m"):
        _close(tfin[key], jfin[key])


def test_mlstm_decode_matches_jax():
    jcfg, tcfg, npm, tpm, _, _ = _blocks()
    b = 3
    jst = JX.init_mlstm_state(jcfg, b, jnp.float32)
    tst = TX.init_mlstm_state(tcfg, b, torch.float32, device="cpu")
    for key in tst:
        assert tuple(tst[key].shape) == jst[key].shape, key
    xs = _x(b, 6, jcfg.d_model, 8)
    jdec = jax.jit(lambda p, x, s: JX.mlstm_decode(p, x, s, jcfg))
    for t in range(6):
        xt = xs[:, t:t + 1]
        jy, jst = jdec(npm, xt, jst)
        c_before = tst["c"]
        ty, tst = TX.mlstm_decode(tpm, torch.from_numpy(xt), tst, tcfg)
        assert tst["c"] is c_before            # C is updated in place
        _close(ty, jy)
        for key in tst:
            _close(tst[key], jst[key])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("length", [20, 140])
def test_decode_after_prefill_matches_forward(kind, length):
    """Prefill L-1 tokens, decode the last one: equal to the forward's last
    position over all L tokens (the state handover is exact)."""
    _, tcfg, _, tpm, _, tps = _blocks()
    fwd, dec, p = ((TX.mlstm_forward, TX.mlstm_decode, tpm)
                   if kind == "mlstm" else
                   (TX.slstm_forward, TX.slstm_decode, tps))
    x = torch.from_numpy(_x(2, length, tcfg.d_model, 11))
    full, _ = fwd(p, x, tcfg)
    _, st = fwd(p, x[:, :length - 1], tcfg)
    y, _ = dec(p, x[:, length - 1:], st, tcfg)
    _close(y[:, 0], full[:, -1].numpy(), DEC_TOL)


@pytest.mark.parametrize("b,length", [(2, 16), (1, 7)])
def test_slstm_forward_matches_jax(b, length):
    jcfg, tcfg, _, _, nps, tps = _blocks()
    x = _x(b, length, jcfg.d_model, 21 + length)
    jy, jst = jax.jit(lambda p, x: JX.slstm_forward(p, x, jcfg))(nps, x)
    ty, tst = TX.slstm_forward(tps, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    assert set(tst) == set(jst) == {"c", "n", "h", "m"}
    for key in tst:
        _close(tst[key], jst[key])


def test_slstm_decode_matches_jax():
    jcfg, tcfg, _, _, nps, tps = _blocks()
    b = 2
    jst = JX.init_slstm_state(jcfg, b, jnp.float32)
    tst = TX.init_slstm_state(tcfg, b, torch.float32, device="cpu")
    xs = _x(b, 5, jcfg.d_model, 30)
    jdec = jax.jit(lambda p, x, s: JX.slstm_decode(p, x, s, jcfg))
    for t in range(5):
        xt = xs[:, t:t + 1]
        jy, jst = jdec(nps, xt, jst)
        ty, tst = TX.slstm_decode(tps, torch.from_numpy(xt), tst, tcfg)
        _close(ty, jy)
        for key in tst:
            _close(tst[key], jst[key])


def test_slstm_recurrent_term_is_added_head_major():
    """JAX adds the (B,h,4*hd) recurrent term, flattened head-major, to
    the gate-major input term (xlstm.py:265-269): with d = 4*hd and only
    head 0's hidden state nonzero, all of the recurrent output lands on
    gate i, and gates f, z, o see none of it."""
    jcfg, tcfg, _, _, nps, tps = _blocks()
    d, h = tcfg.d_model, tcfg.n_heads
    hd = d // h
    assert 4 * hd == d
    state = TX.init_slstm_state(tcfg, 1, torch.float32, device="cpu")
    state["h"][0, :hd] = torch.from_numpy(_x(1, 1, hd, 5)[0, 0])
    state["m"].zero_()
    gx = torch.zeros((1, 4 * d))
    got = slstm_cell(gx, state, tps["r"].float(), tps["bf"], tcfg.n_heads)
    gr = state["h"][0, :hd] @ tps["r"][0].float()            # head 0's 4*hd
    gi = gr                                                  # gate i only
    logf = torch.log(torch.sigmoid(tps["bf"]) + 1e-9)[None]
    m_new = torch.maximum(logf, gi[None])
    ii = torch.exp(gi[None] - m_new)
    c = ii * torch.tanh(torch.zeros(1, d))                   # gz = 0
    n = torch.exp(logf - m_new) * 0 + ii
    assert torch.allclose(got["m"], m_new)
    assert torch.allclose(got["n"], n)
    assert torch.allclose(got["c"], c)
    assert torch.allclose(got["h"], torch.sigmoid(torch.zeros(1, d)) * c
                          / torch.clamp_min(n, 1e-6))
    jst = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    jgot = JX._slstm_cell(nps, jnp.asarray(gx.numpy()), jst, jcfg)
    for key in got:
        _close(got[key], jgot[key])


def test_geglu_uses_the_tanh_gelu():
    """``jax.nn.gelu`` defaults to the tanh approximation (xlstm.py:293,
    302); the port's sLSTM feed-forward uses the same, which differs from
    the exact erf form by more than ten times the parity tolerance."""
    _, tcfg, _, _, nps, tps = _blocks()
    y = torch.from_numpy(_x(2, 3, tcfg.d_model, 40) * 3)
    got = TX._geglu_out(tps, y)
    up, gate = torch.chunk(y @ tps["ff_up"], 2, dim=-1)
    tanh_form = (F.gelu(up, approximate="tanh") * gate) @ tps["ff_down"]
    erf_form = (F.gelu(up) * gate) @ tps["ff_down"]
    assert torch.allclose(got, tanh_form, atol=1e-6)
    assert (got - erf_form).abs().max() > 10 * TOL["atol"]
    jup = jnp.asarray(up.numpy())
    _close(F.gelu(up, approximate="tanh"), jax.nn.gelu(jup))


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _model():
    jcfg, tcfg = jreg.reduced_config(ARCH), treg.reduced_config(ARCH)
    jparams = jax.jit(lambda k: JT.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S),
                                               dtype=np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


def test_forward_logits_match_jax():
    jcfg, tcfg, jp, tp, tokens = _model()
    jl, _, _ = jax.jit(lambda p, t: JT.forward(p, t, jcfg))(
        jp, jnp.asarray(tokens))
    tl, aux, states = TT.forward(tp, torch.from_numpy(tokens), tcfg)
    assert tl.shape == (B, S, tcfg.vocab) and states is None
    assert float(aux) == 0.0
    _close(tl, jl)


def test_prefill_logits_and_states_match_jax():
    jcfg, tcfg, jp, tp, tokens = _model()
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


def test_decode_matches_jax_and_forward():
    jcfg, tcfg, jp, tp, tokens = _model()
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
        _close(tl[:, 0], tfull[:, t].numpy(), DEC_TOL)
    for t_s, j_s in zip(tst, jst):           # the carried states agree too
        for key in t_s:
            _close(t_s[key], j_s[key])


def test_prefill_then_decode_matches_forward():
    _, tcfg, _, tp, tokens = _model()
    tt = torch.from_numpy(tokens)
    tfull, _, _ = TT.forward(tp, tt, tcfg)
    _, st = TM.make_prefill_step(tcfg)(tp, {"tokens": tt[:, :S - 1]})
    states = TT.init_decode_state(tcfg, B, S, torch.float32, device="cpu")
    for big, pre in zip(states, st):
        for key in big:
            big[key].copy_(pre[key])          # recurrent leaves: whole
    tl, _ = TM.make_serve_step(tcfg)(tp, states, tt[:, S - 1:],
                                     torch.full((B, 1), S - 1))
    _close(tl[:, 0], tfull[:, S - 1].numpy(), DEC_TOL)


@pytest.mark.parametrize("reduced", [False, True])
def test_count_params_matches_jax(reduced):
    get = "reduced_config" if reduced else "get_config"
    tcfg, jcfg = getattr(treg, get)(ARCH), getattr(jreg, get)(ARCH)
    assert TM.count_params(tcfg) == JM.count_params(jcfg)
    assert tcfg.n_params() == jcfg.n_params()
    if not reduced:
        assert TM.count_params(tcfg) == 2_020_493_648


def test_params_tree_crosses_both_ways():
    """The stacked (sLSTM, mLSTM) tree, f32 gate weights among bf16 ones,
    round-trips bit for bit; the port's own init has the same leaves."""
    jcfg = jreg.reduced_config(ARCH).with_(dtype="bfloat16")
    jp = jax.jit(lambda k: JT.init_params(k, jcfg))(jax.random.PRNGKey(3))
    npt = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(npt, "cpu")
    assert tp["blocks"][1]["mlstm"]["wq"].dtype == torch.bfloat16
    assert tp["blocks"][1]["mlstm"]["wi"].dtype == torch.float32
    tcfg = treg.reduced_config(ARCH).with_(dtype="bfloat16")
    own = TT.init_params(torch.Generator().manual_seed(0), tcfg,
                         device="cpu")
    flat_a = jax.tree_util.tree_leaves(npt)
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in tree_leaves(own)] == \
        [(a.shape, str(a.dtype)) for a in flat_a]
    back = params_to_numpy(tp, bf16_dtype=np.dtype(jnp.bfloat16))
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_training_runtime_refuses_the_family(tmp_path):
    """The runtime trains the xLSTM family (through mlstm's backward; the
    name is the test's from when it refused it): reduced steps on one
    batch lower the loss."""
    cfg = treg.reduced_config(ARCH)
    data = tdp.DataConfig(seq_len=16, global_batch=2, vocab=cfg.vocab)
    rt = TL.RuntimeConfig(total_steps=4, checkpoint_every=0,
                          ckpt_dir=str(tmp_path))
    ocfg = tadamw.AdamWConfig(lr=5e-3, warmup_steps=1, total_steps=10)
    runtime = TL.FaabricTrainRuntime(cfg, ocfg, data, rt, device="cpu")
    one = tdp.make_batch(data, 0)
    _, out = runtime.run(seed=0, batch_fn=lambda d, s: one)
    losses = out["losses"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
