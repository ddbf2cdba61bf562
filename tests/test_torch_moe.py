"""The port's MoE layer (``models/moe.py``) against the JAX package on the
reduced granite config (f32), same weights and inputs: routing, the bf16
dispatch and combine tensors (bit for bit), the whole layer against both
JAX paths (the Pallas kernel in interpret mode and the einsum path), the
capacity drop, and the group-size limit.  Layer tolerance: the JAX
package's own kernel-vs-einsum test, atol 1e-5 / rtol 1e-4."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import moe as JM
from repro_torch.configs import registry as treg
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models import moe as TM
from repro_torch.weights import params_from_numpy

torch.set_num_threads(2)   # several test workers share the cores

ARCH = "granite-moe-1b-a400m"


@functools.lru_cache(maxsize=None)
def _params(seed=25):
    jcfg = jreg.reduced_config(ARCH)
    jp = jax.jit(lambda k: JM.init_moe(k, jcfg))(jax.random.PRNGKey(seed))
    npp = jax.tree.map(np.asarray, jp)
    return npp, params_from_numpy(npp, "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_route_matches_jax():
    jcfg, tcfg = jreg.reduced_config(ARCH), treg.reduced_config(ARCH)
    npp, tp = _params()
    x = _x((2, 64, jcfg.d_model), 1)
    jg, ji, ja = JM._route(jnp.asarray(npp["router"]), jnp.asarray(x), jcfg)
    tg, ti, ta = TM._route(tp["router"], torch.from_numpy(x), tcfg)
    assert ti.shape == (2, 64, tcfg.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


@pytest.mark.parametrize("capacity", [8, 16, 64])
def test_dispatch_tensors_bit_exact_bf16(capacity):
    jcfg, tcfg = jreg.reduced_config(ARCH), treg.reduced_config(ARCH)
    npp, _ = _params()
    x = _x((2, 64, jcfg.d_model), 2)
    jg, ji, _ = JM._route(jnp.asarray(npp["router"]), jnp.asarray(x), jcfg)
    jd, jc = JM._dispatch_tensors(jg, ji, jcfg, capacity)
    td, tc = TM._dispatch_tensors(torch.tensor(np.asarray(jg)),
                                  torch.tensor(np.asarray(ji)), tcfg,
                                  capacity)
    assert td.dtype == tc.dtype == torch.bfloat16
    for t, j in ((td, jd), (tc, jc)):
        words = np.asarray(j).view(np.uint16)
        np.testing.assert_array_equal(t.view(torch.int16).numpy()
                                      .view(np.uint16), words)
    # every kept (token, k) pair has one slot; none past capacity
    assert float(td.float().sum()) <= 2 * 64 * tcfg.top_k


@pytest.mark.parametrize("pallas", [True, False])
@pytest.mark.parametrize("cf,shape", [(1.25, (2, 64)), (8.0, (2, 64)),
                                      (1.25, (1, 1024)), (1.25, (8, 1))])
def test_moe_ffn_matches_jax(pallas, cf, shape):
    jcfg = jreg.reduced_config(ARCH).with_(capacity_factor=cf,
                                           use_pallas_kernels=pallas)
    tcfg = treg.reduced_config(ARCH).with_(capacity_factor=cf)
    npp, tp = _params()
    x = _x(shape + (jcfg.d_model,), 3)
    jy, ja = jax.jit(lambda p, x: JM.moe_ffn(p, x, jcfg))(npp, x)
    before = gmm_ops.launches
    ty, ta = TM.moe_ffn(tp, torch.from_numpy(x), tcfg)
    assert gmm_ops.launches == before      # the CPU runs the plain version
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


def test_capacity_drops_tokens_as_jax_does():
    """Mirror of tests/test_model_math.py:121: a low capacity factor zeroes
    some token outputs, a high one does not; and the port drops the same
    tokens as the JAX package."""
    tcfg = treg.reduced_config(ARCH)
    jcfg = jreg.reduced_config(ARCH)
    npp, tp = _params()
    x = _x((2, 64, tcfg.d_model), 26)
    y_hi, _ = TM.moe_ffn(tp, torch.from_numpy(x),
                         tcfg.with_(capacity_factor=8.0))
    y_lo, _ = TM.moe_ffn(tp, torch.from_numpy(x),
                         tcfg.with_(capacity_factor=0.25))
    zeros_lo = int((y_lo.abs().sum(-1) < 1e-9).sum())
    zeros_hi = int((y_hi.abs().sum(-1) < 1e-9).sum())
    assert zeros_lo > zeros_hi
    jy_lo, _ = JM.moe_ffn(npp, jnp.asarray(x),
                          jcfg.with_(capacity_factor=0.25))
    jzero = np.abs(np.asarray(jy_lo)).sum(-1) < 1e-9
    np.testing.assert_array_equal((y_lo.abs().sum(-1) < 1e-9).numpy(),
                                  jzero)


@pytest.mark.parametrize("tokens", [600, 513, 1500])
def test_group_size_limit_raises(tokens):
    """Above 512 tokens the count must be a multiple of 512, as the JAX
    package's reshape requires (moe.py:91-94)."""
    tcfg = treg.reduced_config(ARCH)
    _, tp = _params()
    x = torch.zeros((1, tokens, tcfg.d_model))
    with pytest.raises(ValueError, match="multiple of the routing group"):
        TM.moe_ffn(tp, x, tcfg)
    with pytest.raises(TypeError):     # the JAX package fails the same way
        JM.moe_ffn(_params()[0], jnp.zeros((1, tokens, tcfg.d_model)),
                   jreg.reduced_config(ARCH))


def test_expert_capacity_matches_jax():
    for arch in (ARCH, "phi3.5-moe-42b-a6.6b"):
        for group in (8, 256, 512):
            for cf in (1.25, 8.0, 0.25):
                assert TM.expert_capacity(
                    treg.get_config(arch).with_(capacity_factor=cf),
                    group) == JM.expert_capacity(
                        jreg.get_config(arch).with_(capacity_factor=cf),
                        group)
