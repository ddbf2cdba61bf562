"""repro_torch.models.layers against repro.models.layers, f32, atol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as J
from repro_torch.models import layers as T

torch.set_num_threads(2)   # several test workers share the cores

ATOL = 1e-5


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=1e-5)


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 48)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32) * 3
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    _close(T.rms_norm(torch.from_numpy(w), torch.from_numpy(x), 1e-5),
           J.rms_norm(jnp.asarray(w), jnp.asarray(x), 1e-5))


@pytest.mark.parametrize("shape,dtype", [((3, 64), "float32"),
                                         ((2, 5, 48), "float32"),
                                         ((4, 768), "bfloat16")])
def test_layer_norm(shape, dtype):
    """Mean and variance in f32 (the population variance), cast back to
    the input's dtype; bf16 rounds once at the end in both packages."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=shape) * 3 + 1.5).astype(np.float32)
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    b = rng.normal(size=shape[-1:]).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(dtype)
    t = T.layer_norm({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                     tx, 1e-5)
    j = J.layer_norm({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jx, 1e-5)
    assert t.dtype == tx.dtype
    atol = ATOL if dtype == "float32" else 0.0
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)),
                               atol=atol, rtol=1e-5 if atol else 1e-2)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
@pytest.mark.parametrize("hd", [16, 64, 80])
def test_apply_rope(theta, hd):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, 3, hd)).astype(np.float32)
    pos = np.stack([np.arange(12), np.arange(12) + 37]).astype(np.int32)
    _close(T.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           J.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), atol=2e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    rng = np.random.default_rng(2)
    d, ff = 32, 96
    p = {"w1": rng.normal(size=(d, ff)) * d ** -0.5,
         "w2": rng.normal(size=(ff, d)) * ff ** -0.5}
    if act == "silu":
        p["w3"] = rng.normal(size=(d, ff)) * d ** -0.5
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 7, d)).astype(np.float32)
    _close(T.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x), act),
           J.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                 act))


def test_matmul_and_dense_init():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    _close(T.matmul(torch.from_numpy(x), torch.from_numpy(w)),
           J.matmul(jnp.asarray(x), jnp.asarray(w)))
    gen = torch.Generator().manual_seed(0)
    a = T.dense_init(gen, (256, 512), torch.float32, device="cpu")
    assert a.shape == (256, 512) and a.dtype == torch.float32
    std = 256 ** -0.5
    assert float(a.abs().max()) <= 3 * std + 1e-6
    assert abs(float(a.std()) / std - 0.9866) < 0.02   # truncated at 3 sigma
    b = T.dense_init(torch.Generator().manual_seed(0), (256, 512),
                     torch.bfloat16, device="cpu")
    assert torch.equal(b, a.to(torch.bfloat16))
    assert T.dense_init(None, (3, 4), torch.bfloat16,
                        device="meta").is_meta
