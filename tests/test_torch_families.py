"""The port's MoE (granite-moe-1b-a400m), hybrid (zamba2-2.7b), audio
(whisper-small) and VLM (llama-3.2-vision-11b) models against the JAX
package on the same weights, reduced configs, f32: forward logits,
prefill logits and states, decode, prefill-then-decode, parameter counts,
the params tree with zamba2's shared block, and the training runtime's
refusal of each family.  Tolerances as the dense model's tests
(tests/test_torch_model.py): atol 1e-4 against JAX, 5e-4 between decode
and the forward.

The multimodal families run with their extras (encoder frames, image
tokens) drawn from a seed and the vision model's CROSS_ATTN gates drawn
from N(0, 1) (``tests/_multimodal.py``: at init they are 0, which hides
the cross-attention).  Their decode states take the cross-attention K/V
of a prefill; a planted fault in the cross-attention block fails the
forward's parity under drawn gates, and passes it under zero gates."""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _multimodal import CROSS_KEYS, MULTIMODAL, draw_gates, extras, \
    with_cross
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

FAMILIES = ["granite-moe-1b-a400m", "zamba2-2.7b", *MULTIMODAL]
B, S = 2, 16
ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _setup(arch, cf=None, gates=True):
    jcfg = jreg.reduced_config(arch)
    tcfg = treg.reduced_config(arch)
    if cf is not None:
        jcfg, tcfg = (c.with_(capacity_factor=cf) for c in (jcfg, tcfg))
    npt = jax.tree.map(np.asarray, jax.jit(
        lambda k: JT.init_params(k, jcfg))(jax.random.PRNGKey(0)))
    if gates:
        draw_gates(npt, jcfg)
    jparams = jax.tree.map(jnp.asarray, npt)
    tparams = params_from_numpy(npt, "cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S),
                                               dtype=np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


def _jx(cfg, b=B):
    return {k: jnp.asarray(v) for k, v in extras(cfg, b).items()}


def _tx(cfg, b=B):
    return {k: torch.from_numpy(v) for k, v in extras(cfg, b).items()}


def _decode_states(jcfg, tcfg, jp, tp, tokens, max_len):
    """Zero decode states of both packages, their cross-attention K/V
    (the multimodal families') from a prefill of the first token."""
    jst = JT.init_decode_state(jcfg, B, max_len, jcfg.param_dtype())
    tst = TT.init_decode_state(tcfg, B, max_len, torch.float32,
                               device="cpu")
    if tcfg.family in ("audio", "vlm"):
        _, jpre = jax.jit(JM.make_prefill_step(jcfg))(
            jp, {"tokens": jnp.asarray(tokens[:, :1]), **_jx(jcfg)})
        _, tpre = TM.make_prefill_step(tcfg)(
            tp, {"tokens": torch.from_numpy(tokens[:, :1]), **_tx(tcfg)})
        jst, tst = with_cross(jcfg, jst, jpre), with_cross(tcfg, tst, tpre)
    return jst, tst


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_and_aux_match_jax(arch):
    jcfg, tcfg, jp, tp, tokens = _setup(arch)
    jl, jaux, _ = jax.jit(lambda p, t, x: JT.forward(p, t, jcfg, x))(
        jp, jnp.asarray(tokens), _jx(jcfg))
    tl, aux, states = TT.forward(tp, torch.from_numpy(tokens), tcfg,
                                 _tx(tcfg))
    assert tl.shape == (B, S, tcfg.vocab) and states is None
    _close(tl, jl)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_logits_and_states_match_jax(arch):
    jcfg, tcfg, jp, tp, tokens = _setup(arch)
    jl, jst = jax.jit(JM.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(tokens), **_jx(jcfg)})
    tl, tst = TM.make_prefill_step(tcfg)(
        tp, {"tokens": torch.from_numpy(tokens), **_tx(tcfg)})
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
    jst, tst = _decode_states(jcfg, tcfg, jp, tp, tokens, S)
    tfull, _, _ = TT.forward(tp, torch.from_numpy(tokens), tcfg, _tx(tcfg))
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
    jst, tst = _decode_states(jcfg, tcfg, jp, tp, tokens, 8)
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
    tfull, _, _ = TT.forward(tp, tt, tcfg, _tx(tcfg))
    _, st = TM.make_prefill_step(tcfg)(tp, {"tokens": tt[:, :S - 1],
                                            **_tx(tcfg)})
    states = TT.init_decode_state(tcfg, B, S, torch.float32, device="cpu")
    for kind, big, pre in zip(tcfg.period(), states, st):
        for key in big:
            if key in ("k", "v") and kind != "cross_attn":
                big[key][:, :, :S - 1] = pre[key]
            else:       # recurrent and cross-attention leaves: whole
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
    later = ("training of the audio and VLM families" if arch in MULTIMODAL
             else "training of the MoE and hybrid families")
    with pytest.raises(NotImplementedError, match=later):
        TL.FaabricTrainRuntime(cfg, tadamw.AdamWConfig(), data, rt,
                               device="cpu")


@pytest.mark.parametrize("arch", MULTIMODAL)
def test_multimodal_tree_crosses_both_ways_bit_exact(arch):
    """The audio tree (with its ``encoder`` subtree) and the VLM tree
    (with its f32 0-d gates, stacked to (n_per,) in a bf16 tree) go to
    the port and back bit for bit, and the port's own init has the same
    leaves, shapes and dtypes."""
    jcfg = jreg.reduced_config(arch).with_(dtype="bfloat16")
    npt = jax.tree.map(np.asarray, jax.jit(
        lambda k: JT.init_params(k, jcfg))(jax.random.PRNGKey(3)))
    draw_gates(npt, jcfg)
    tp = params_from_numpy(npt, "cpu")
    tcfg = treg.reduced_config(arch).with_(dtype="bfloat16")
    own = TT.init_params(torch.Generator().manual_seed(0), tcfg,
                         device="cpu")
    if arch == "whisper-small":
        assert tp["encoder"]["blocks"]["attn"]["wq"].shape[0] == \
            tcfg.n_enc_layers
    else:
        gate = tp["blocks"][1]["gate_attn"]
        assert gate.dtype == torch.float32 and gate.shape == \
            (tcfg.n_periods(),)
        assert bool((own["blocks"][1]["gate_mlp"] == 0).all())
    leaves = jax.tree_util.tree_leaves(npt)
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in tree_leaves(own)] == \
        [(a.shape, str(a.dtype)) for a in leaves]
    back = params_to_numpy(tp, bf16_dtype=np.dtype(jnp.bfloat16))
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(leaves) == len(flat_b)
    for a, b in zip(leaves, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _lane_swapped(orig):
    """``attention`` whose cross-attention K/V come from the other lane
    of the batch: the image of request 1 serves request 0."""
    def attention(params, x, cfg, positions, **kw):
        if kw.get("kv_x") is not None:
            kw["kv_x"] = kw["kv_x"].roll(1, 0)
        return orig(params, x, cfg, positions, **kw)
    return attention


FAULTS = {
    "gate_tanh_dropped": lambda: mock.patch.object(
        TT, "_gate", lambda g, x: g.to(x.dtype)),
    "image_kv_from_another_lane": lambda: mock.patch.object(
        TT.attn, "attention", _lane_swapped(TT.attn.attention)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("gates", ["drawn", "zero"])
def test_planted_cross_attention_fault(fault, gates):
    """A copy of the CROSS_ATTN block with a planted fault against the
    JAX forward of the vision model: with drawn gates the parity check
    fails, with the init's zero gates (the identity block) it passes,
    which is why every check draws the gates."""
    jcfg, tcfg, jp, tp, tokens = _setup("llama-3.2-vision-11b",
                                        gates=gates == "drawn")
    jl = jax.jit(lambda p, t, x: JT.forward(p, t, jcfg, x)[0])(
        jp, jnp.asarray(tokens), _jx(jcfg))
    with FAULTS[fault]():
        tl, _, _ = TT.forward(tp, torch.from_numpy(tokens), tcfg,
                              _tx(tcfg))
    if gates == "zero":
        _close(tl, jl)
    else:
        with pytest.raises(AssertionError):
            _close(tl, jl)


@pytest.mark.parametrize("arch", MULTIMODAL)
def test_decode_keeps_the_cross_caches(arch):
    """A decode step writes its self-attention row in place and leaves
    the cross-attention K/V (image tokens, encoder states) as they were:
    same tensors, same values."""
    jcfg, tcfg, jp, tp, tokens = _setup(arch)
    _, tst = _decode_states(jcfg, tcfg, jp, tp, tokens, S)
    before = [{k: st[k].clone() for k in CROSS_KEYS.get(kind, ())}
              for kind, st in zip(tcfg.period(), tst)]
    ids = [{k: st[k].data_ptr() for k in b} for st, b in zip(tst, before)]
    for t in range(3):
        TM.make_serve_step(tcfg)(tp, tst,
                                 torch.from_numpy(tokens[:, t:t + 1]),
                                 torch.full((B, 1), t))
    for st, b, i in zip(tst, before, ids):
        for k in b:
            assert st[k].data_ptr() == i[k] and torch.equal(st[k], b[k]), k
    self_k = tst[0]["k"]
    assert bool((self_k[:, :, :3] != 0).any())
    assert bool((self_k[:, :, 3:] == 0).all())
