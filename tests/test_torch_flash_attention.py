"""The port's flash_attention (plain version and CPU wrapper path) against
the JAX package's Pallas kernel in interpret mode and its jnp oracle, over
the shape grid of tests/test_kernels.py.  The CUDA kernel itself runs only
on a GPU: its tests are in test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as JK
from repro.kernels.flash_attention import ops as JO
from repro.kernels.flash_attention import ref as JR
from repro.models.attention import sdpa as jsdpa
from repro_torch.kernels.flash_attention import ops as TO
from repro_torch.kernels.flash_attention import ref as TR
from repro_torch.models.attention import sdpa as tsdpa

torch.set_num_threads(2)   # several test workers share the cores

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, qshape, kshape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=qshape).astype(np.float32),
            rng.normal(size=kshape).astype(np.float32),
            rng.normal(size=kshape).astype(np.float32))


def _both(arrs, dtype):
    js = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return js, ts


def _close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("b,h,kv,s,hd", [
    (2, 4, 4, 256, 64), (1, 8, 2, 256, 64), (2, 4, 2, 512, 128),
    (1, 2, 1, 128, 64),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128),
                                           (False, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax(b, h, kv, s, hd, causal, window, dtype):
    arrs = _inputs(s + hd + h, (b, h, s, hd), (b, kv, s, hd))
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    jkernel = JK.flash_attention(jq, jk, jv, causal=causal, window=window,
                                 interpret=True)
    jref = JR.attention_ref(jq, jk, jv, causal=causal, window=window)
    tref = TR.attention_ref(tq, tk, tv, causal=causal, window=window)
    assert tref.dtype == tq.dtype and tref.shape == tq.shape
    _close(tref, jref, dtype)
    _close(tref, jkernel, dtype)
    # the wrapper on CPU tensors, model layout (B,S,H,hd)
    TO.reset_launches()
    tout = TO.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                              tv.transpose(1, 2), causal=causal,
                              window=window).transpose(1, 2)
    assert TO.launches == 0
    _close(tout, jkernel, dtype)


@pytest.mark.parametrize("hd", [80, 16])
def test_ops_layout_and_padding(hd):
    b, s, h, kv = 2, 256, 4, 2       # hd=80 pads to 128, hd=16 to 64
    arrs = _inputs(hd, (b, s, h, hd), (b, s, kv, hd))
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, "float32")
    TO.reset_launches()
    tout = TO.flash_attention(tq, tk, tv, causal=True)
    assert TO.launches == 0 and tout.shape == tq.shape
    _close(tout, JO.flash_attention(jq, jk, jv, causal=True,
                                    interpret=True), "float32")
    _close(tout, jsdpa(jq, jk, jv, causal=True), "float32")
    _close(tsdpa(tq, tk, tv, causal=True), jsdpa(jq, jk, jv, causal=True),
           "float32")


@pytest.mark.parametrize("s,window", [(100, 0), (77, 16)])
def test_ragged_sequence_on_cpu(s, window):
    """The CUDA kernel takes any S; its CPU path and oracle must too."""
    arrs = _inputs(s, (1, s, 4, 64), (1, s, 2, 64))
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, "float32")
    tout = TO.flash_attention(tq, tk, tv, causal=True, window=window)
    jref = JR.attention_ref(*(jnp.swapaxes(a, 1, 2) for a in (jq, jk, jv)),
                            causal=True, window=window)
    _close(tout, jnp.swapaxes(jref, 1, 2), "float32")


def test_cpu_tensor_never_reaches_the_kernel():
    q = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="must be on"):
        TO._launch(q, q[:, :1].contiguous(), q[:, :1].contiguous(),
                   causal=True, window=0, scale=0.125)
    assert TO.launches == 0
