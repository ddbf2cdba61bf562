"""The port's Mamba2 block (``models/ssm.py``) against the JAX package on
the reduced zamba2 config (f32), same weights and inputs: the prefill
block (y and every state leaf), the recurrent decode, and decode after a
prefill against the forward over the longer sequence (the mirror of
tests/test_decode_consistency.py:78).  Tolerances: atol 1e-4 / rtol 1e-4
against the JAX block; decode against the forward as the JAX package's
own consistency test, atol 5e-4 / rtol 1e-3."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import ssm as JS
from repro_torch.configs import registry as treg
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models import ssm as TS
from repro_torch.weights import params_from_numpy

torch.set_num_threads(2)   # several test workers share the cores

ARCH = "zamba2-2.7b"
TOL = dict(atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _setup(seed=0):
    jcfg, tcfg = jreg.reduced_config(ARCH), treg.reduced_config(ARCH)
    jp = jax.jit(lambda k: JS.init_mamba(k, jcfg))(jax.random.PRNGKey(seed))
    # non-trivial dt bias and skip, so both terms are tested
    rng = np.random.default_rng(seed)
    npp = jax.tree.map(np.asarray, jp)
    npp["dt_bias"] = rng.standard_normal(npp["dt_bias"].shape).astype(
        np.float32) * 0.5
    npp["d_skip"] = (1 + rng.standard_normal(npp["d_skip"].shape) * 0.3
                     ).astype(np.float32)
    return jcfg, tcfg, npp, params_from_numpy(npp, "cpu")


def _x(b, length, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, length, d)).astype(np.float32)


@pytest.mark.parametrize("b,length", [(2, 64), (1, 20), (2, 32)])
def test_mamba_forward_matches_jax(b, length):
    jcfg, tcfg, npp, tp = _setup()
    x = _x(b, length, jcfg.d_model, length)
    jy, jst = jax.jit(lambda p, x: JS.mamba_forward(p, x, jcfg))(npp, x)
    before = scan_ops.launches
    ty, tst = TS.mamba_forward(tp, torch.from_numpy(x), tcfg)
    assert scan_ops.launches == before    # the CPU runs the plain version
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert set(tst) == set(jst) == {"ssm", "conv_x", "conv_b", "conv_c"}
    for key in tst:
        assert tuple(tst[key].shape) == jst[key].shape, key
        assert tst[key].dtype == torch.float32
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   **TOL)


def test_conv_tails_hold_the_pre_conv_streams():
    """A prompt shorter than the conv window: the tails are zero in front
    and hold the projections themselves (not the conv outputs)."""
    _, tcfg, _, tp = _setup()
    x = torch.from_numpy(_x(1, 2, tcfg.d_model, 9))
    _, st = TS.mamba_forward(tp, x, tcfg)
    assert st["conv_x"].shape == (1, TS.D_CONV - 1, TS.dims(tcfg)[0])
    assert bool((st["conv_x"][:, 0] == 0).all())
    torch.testing.assert_close(st["conv_b"][:, 1:], x @ tp["in_b"])


def test_mamba_decode_matches_jax():
    jcfg, tcfg, npp, tp = _setup()
    b = 3
    jst = JS.init_mamba_state(jcfg, b, jnp.float32)
    tst = TS.init_mamba_state(tcfg, b, torch.float32, device="cpu")
    for key in tst:
        assert tuple(tst[key].shape) == jst[key].shape
    xs = _x(b, 6, jcfg.d_model, 4)
    jdec = jax.jit(lambda p, x, s: JS.mamba_decode(p, x, s, jcfg))
    for t in range(6):
        xt = xs[:, t:t + 1]
        jy, jst = jdec(npp, xt, jst)
        ty, new = TS.mamba_decode(tp, torch.from_numpy(xt), tst, tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for key in new:
            np.testing.assert_allclose(new[key].numpy(),
                                       np.asarray(jst[key]), **TOL)
        tst = new


@pytest.mark.parametrize("length", [32, 20])
def test_decode_after_prefill_matches_forward(length):
    """Prefill L-1 tokens, decode the last one: equal to the forward's last
    position over all L tokens (the state handover is exact)."""
    _, tcfg, _, tp = _setup()
    x = torch.from_numpy(_x(2, length, tcfg.d_model, 11))
    full, _ = TS.mamba_forward(tp, x, tcfg)
    _, st = TS.mamba_forward(tp, x[:, :length - 1], tcfg)
    y, _ = TS.mamba_decode(tp, x[:, length - 1:], st, tcfg)
    np.testing.assert_allclose(y[:, 0].numpy(), full[:, -1].numpy(),
                               atol=5e-4, rtol=1e-3)


def test_init_mamba_shapes_match_jax():
    jcfg, tcfg = jreg.get_config(ARCH), treg.get_config(ARCH)
    assert TS.dims(tcfg) == JS.dims(jcfg) == (5120, 80)
    jp = jax.eval_shape(lambda k: JS.init_mamba(k, jcfg),
                        jax.ShapeDtypeStruct((2,), jnp.uint32))
    tp = TS.init_mamba(None, tcfg, device="meta")
    assert set(tp) == set(jp)
    for key in tp:
        assert tuple(tp[key].shape) == jp[key].shape, key
        assert str(tp[key].dtype).split(".")[-1] == str(jp[key].dtype)
