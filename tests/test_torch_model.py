"""The port's dense model (forward, prefill, decode) against the JAX
package on the same weights, reduced configs, f32, atol 1e-4."""
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
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.weights import params_from_numpy, params_to_numpy

torch.set_num_threads(2)   # several test workers share the cores

DENSE = ["llama3.2-1b", "llama3.2-3b", "glm4-9b", "minitron-4b"]
B, S = 2, 16
ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = jreg.reduced_config(arch)
    tcfg = treg.reduced_config(arch)
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


@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match_jax(arch):
    jcfg, tcfg, jp, tp, tokens = _setup(arch)
    jl, _, _ = jax.jit(lambda p, t: JT.forward(p, t, jcfg))(
        jp, jnp.asarray(tokens))
    tl, aux, states = TT.forward(tp, torch.from_numpy(tokens), tcfg)
    assert tl.shape == (B, S, tcfg.vocab) and states is None
    assert float(aux) == 0.0
    _close(tl, jl)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_and_states_match_jax(arch):
    jcfg, tcfg, jp, tp, tokens = _setup(arch)
    jl, jst = jax.jit(JM.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(tokens)})
    tl, tst = TM.make_prefill_step(tcfg)(tp,
                                         {"tokens": torch.from_numpy(tokens)})
    assert tl.dtype == torch.float32 and tl.shape == (B, 1, tcfg.vocab)
    _close(tl, jl)
    assert len(tst) == len(jst)
    for t_s, j_s in zip(tst, jst):
        assert set(t_s) == set(j_s)
        for key in t_s:
            assert tuple(t_s[key].shape) == j_s[key].shape
            _close(t_s[key], j_s[key])


@pytest.mark.parametrize("arch,window", [(a, 0) for a in DENSE]
                         + [("llama3.2-1b", 6)])
def test_decode_matches_jax_and_forward(arch, window):
    jcfg, tcfg, jp, tp, tokens = _setup(arch)
    jserve = jax.jit(JM.make_serve_step(jcfg, window=window))
    tserve = TM.make_serve_step(tcfg, window=window)
    jst = JT.init_decode_state(jcfg, B, S, jcfg.param_dtype(), window=window)
    tst = TT.init_decode_state(tcfg, B, S, torch.float32, window=window,
                               device="cpu")
    ctx = {"window": window}
    tfull, _, _ = TT.forward(tp, torch.from_numpy(tokens), tcfg, ctx)
    for t in range(S):
        pos = np.full((B, 1), t, np.int32)
        jl, jst = jserve(jp, jst, jnp.asarray(tokens[:, t:t + 1]),
                         jnp.asarray(pos))
        tl, tst = tserve(tp, tst, torch.from_numpy(tokens[:, t:t + 1]),
                         torch.from_numpy(pos))
        _close(tl, jl)
        _close(tl[:, 0], tfull[:, t], atol=5e-4)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_matches_forward(arch):
    jcfg, tcfg, jp, tp, tokens = _setup(arch)
    tt = torch.from_numpy(tokens)
    tfull, _, _ = TT.forward(tp, tt, tcfg)
    _, st = TM.make_prefill_step(tcfg)(tp, {"tokens": tt[:, :S - 1]})
    states = TT.init_decode_state(tcfg, B, S, torch.float32, device="cpu")
    for big, pre in zip(states, st):
        for key in big:
            big[key][:, :, :S - 1] = pre[key]
    tl, _ = TM.make_serve_step(tcfg)(tp, states, tt[:, S - 1:],
                                     torch.full((B, 1), S - 1))
    _close(tl[:, 0], tfull[:, S - 1], atol=5e-4)


def test_count_params_full_llama_matches_jax():
    for arch in ("llama3.2-1b", "minitron-4b"):
        assert TM.count_params(treg.get_config(arch)) == \
            JM.count_params(jreg.get_config(arch))
    assert treg.get_config("llama3.2-1b").n_params() == \
        jreg.get_config("llama3.2-1b").n_params()


def test_params_cross_bit_exact_in_bf16():
    jcfg = jreg.reduced_config("llama3.2-1b").with_(dtype="bfloat16")
    jp = jax.jit(lambda k: JT.init_params(k, jcfg))(jax.random.PRNGKey(3))
    npt = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(npt, "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["blocks"][0]["attn"]["wq"].shape == \
        npt["blocks"][0]["attn"]["wq"].shape
    back = params_to_numpy(tp, bf16_dtype=np.dtype(jnp.bfloat16))
    flat_a = jax.tree_util.tree_leaves(npt)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_unported_families_raise():
    for arch in ("whisper-small", "llama-3.2-vision-11b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TT.init_params(torch.Generator(), treg.reduced_config(arch),
                           device="cpu")
