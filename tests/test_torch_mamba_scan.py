"""The port's mamba_scan plain version (the chunked SSD) and wrapper
against the JAX package: its Pallas kernel in interpret mode, its
sequential oracle ``ref.ssd_ref``, and ``models.ssm.ssd_chunked``, on the
same numpy inputs.  Tolerances: the JAX kernel test's own
(tests/test_kernels.py:183-201), y atol 5e-4 / rtol 1e-3 and the state
atol 5e-5 / rtol 1e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import kernel as JK
from repro.kernels.mamba_scan import ref as JR
from repro.models import ssm as JS
from repro_torch.kernels.mamba_scan import ops as TO
from repro_torch.kernels.mamba_scan import ref as TR

torch.set_num_threads(2)   # several test workers share the cores

Y_TOL = dict(atol=5e-4, rtol=1e-3)
S_TOL = dict(atol=5e-5, rtol=1e-3)


def _inputs(b, length, h, p, n, seed):
    """Model layout: x (B,L,H,P), dt (B,L,H) > 0, a (H,) < 0, b/c (B,L,N)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, length, h, p)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, length, h)))).astype(
        np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    bb, cc = (rng.standard_normal((b, length, n)).astype(np.float32) * 0.5
              for _ in range(2))
    return x, dt, a, bb, cc


def _kernel_layout(x, dt, a):
    return (np.moveaxis(x, 2, 1), np.moveaxis(dt, 2, 1)[..., None],
            a[:, None, None])


# the JAX kernel test's shapes (b, h, l, p, n, chunk), plus a prompt
# shorter than the chunk (q = L) and zamba2's head width at a short L
SHAPES = [(2, 3, 128, 32, 16, 32), (1, 2, 256, 64, 64, 64),
          (2, 2, 64, 16, 8, 16), (1, 2, 40, 16, 8, 64),
          (1, 4, 128, 64, 64, 64)]


@pytest.mark.parametrize("b,h,length,p,n,chunk", SHAPES)
def test_plain_matches_jax_kernel_and_oracle(b, h, length, p, n, chunk):
    x, dt, a, bb, cc = _inputs(b, length, h, p, n, b * length + h)
    y, s = TR.ssd_chunked(*(torch.from_numpy(v) for v in
                            (x, dt, a, bb, cc)), chunk)
    assert y.shape == x.shape and s.shape == (b, h, p, n)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    xk, dtk, ak = _kernel_layout(x, dt, a)
    jy, js = JK.ssd_scan(xk, dtk, ak, bb, cc, chunk=chunk, interpret=True)
    ey, es = JR.ssd_ref(xk, dtk, ak, bb, cc)
    for wy, ws in ((jy, js), (ey, es)):
        np.testing.assert_allclose(y.numpy(), np.moveaxis(np.asarray(wy),
                                                          1, 2), **Y_TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), **S_TOL)


@pytest.mark.parametrize("b,h,length,p,n,chunk", SHAPES)
def test_wrapper_matches_jax_ssd_chunked(b, h, length, p, n, chunk):
    x, dt, a, bb, cc = _inputs(b, length, h, p, n, length + p)
    before = TO.launches
    y, s = TO.ssd(*(torch.from_numpy(v) for v in (x, dt, a, bb, cc)),
                  chunk=chunk)
    assert TO.launches == before          # the CPU runs the plain version
    jy, js = JS.ssd_chunked(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a),
                            jnp.asarray(bb), jnp.asarray(cc), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **Y_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **S_TOL)


def test_bf16_inputs_scan_in_f32_and_round_y_once():
    x, dt, a, bb, cc = _inputs(1, 64, 2, 16, 8, 5)
    xb, bbb, ccb = (torch.from_numpy(v).bfloat16() for v in (x, bb, cc))
    dtt, at = torch.from_numpy(dt), torch.from_numpy(a)
    y, s = TR.ssd_chunked(xb, dtt, at, bbb, ccb, 32)
    y32, s32 = TR.ssd_chunked(xb.float(), dtt, at, bbb.float(), ccb.float(),
                              32)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert torch.equal(y, y32.bfloat16()) and torch.equal(s, s32)


@pytest.mark.parametrize("length,chunk", [(96, 64), (100, 32), (65, 64)])
def test_ragged_tail_raises(length, chunk):
    """L > chunk with L % chunk != 0 cannot be scanned: the JAX kernel
    asserts (kernel.py:84) and ssd_chunked's reshape fails (ssm.py:79-80);
    the port raises ValueError."""
    x, dt, a, bb, cc = _inputs(1, length, 2, 16, 8, 0)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TO.ssd(*(torch.from_numpy(v) for v in (x, dt, a, bb, cc)),
               chunk=chunk)
    with pytest.raises(TypeError):
        JS.ssd_chunked(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a),
                       jnp.asarray(bb), jnp.asarray(cc), chunk)


def test_wrapper_rejects_bad_shapes():
    x, dt, a, bb, cc = (torch.from_numpy(v)
                        for v in _inputs(1, 32, 2, 16, 8, 1))
    with pytest.raises(ValueError, match="shapes"):
        TO.ssd(x, dt[:, :, :1], a, bb, cc, chunk=32)
    with pytest.raises(ValueError, match="shapes"):
        TO.ssd(x, dt, a, bb, cc[..., :4], chunk=32)
    assert jax.default_backend() == "cpu"


# Gradients: the backward kernel's oracle (ref.ssd_chunked_grads, autograd
# of the plain version) and the wrapper's gradient on the CPU against
# jax.grad of models.ssm.ssd_chunked.  Tolerance: each gradient within
# rtol 1e-3 and an atol of 1e-4 times its largest magnitude (f32 sums of
# up to chunk x H terms in another order).
GRAD_GATES = {"jax": (0.0, 1.0), "slow": (-4.6, 0.1)}
GRAD_NAMES = ("dx", "ddt", "da", "db", "dc")


def _grad_inputs(b, length, h, p, n, seed, gates):
    """x, dt, a, b, c as ``_inputs`` (the JAX kernel test's gates) or with
    slow gates (dt about 0.01: the state and its gradient carry over
    several chunks), and dy and d s_fin ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, length, h, p)).astype(np.float32) * 0.5
    mean, std = GRAD_GATES[gates]
    dt = np.log1p(np.exp(rng.standard_normal((b, length, h)) * std
                         + mean)).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    bb, cc = (rng.standard_normal((b, length, n)).astype(np.float32) * 0.5
              for _ in range(2))
    dy = rng.standard_normal((b, length, h, p)).astype(np.float32)
    ds = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return (x, dt, a, bb, cc), dy, ds


def _grad_close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=1e-3,
                               atol=1e-4 * max(1.0, np.abs(j).max()))


@pytest.mark.parametrize("gates", ["jax", "slow"])
@pytest.mark.parametrize("b,h,length,p,n,chunk,with_ds", [
    (2, 3, 128, 32, 16, 32, True), (1, 2, 256, 64, 64, 64, False),
    (1, 2, 40, 16, 8, 64, True)])
def test_grads_match_jax_grad(b, h, length, p, n, chunk, with_ds, gates):
    ins, dy, ds = _grad_inputs(b, length, h, p, n, length + h, gates)
    ds = ds if with_ds else None

    def loss(*args):
        y, s = JS.ssd_chunked(*args, chunk)
        out = jnp.sum(y * dy)
        return out + jnp.sum(s * ds) if ds is not None else out
    jg = jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, ins))
    tins = [torch.from_numpy(v) for v in ins]
    tdy = torch.from_numpy(dy)
    tds = None if ds is None else torch.from_numpy(ds)
    oracle = TR.ssd_chunked_grads(*tins, chunk, tdy, tds)
    leaves = [t.clone().requires_grad_() for t in tins]
    y, s = TO.ssd(*leaves, chunk=chunk)
    wrapper = torch.autograd.grad(
        [y, s] if tds is not None else [y], leaves,
        [tdy, tds] if tds is not None else [tdy])
    for name, o, w, j in zip(GRAD_NAMES, oracle, wrapper, jg):
        assert o.shape == tuple(j.shape), name
        _grad_close(o, j)
        _grad_close(w, j)
    if gates == "slow" and length > chunk:      # the carry is in the check
        _, s = TR.ssd_chunked(*tins, chunk)
        assert TR.carry_share(*tins, chunk, s) > 0.1


@pytest.mark.parametrize("gates", ["slow", "model"])
def test_common_part_grads_match_jax_grad(gates):
    """The backward kernels' common-part inputs (ref.scan_inputs with
    inputs "common": x around SCAN_COMMON, dy without its mean over P, so
    the states' common part cancels in dY S_in): the oracle against
    jax.grad, and the states do share a large common part."""
    x, dt, a, bb, cc, dy = TR.scan_inputs(1, 192, 2, 16, 8, gates=gates,
                                          inputs="common", seed=3)
    ins = tuple(t.numpy() for t in (x, dt, a, bb, cc))

    def loss(*args):
        y, _ = JS.ssd_chunked(*args, 64)
        return jnp.sum(y * dy.numpy())
    jg = jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, ins))
    oracle = TR.ssd_chunked_grads(x, dt, a, bb, cc, 64, dy)
    for name, o, j in zip(GRAD_NAMES, oracle, jg):
        _grad_close(o, j)
    _, s = TR.ssd_chunked(x[:, :128], dt[:, :128], a, bb[:, :128],
                          cc[:, :128], 64)
    spread = (s - s.mean(2, keepdim=True)).abs().max()
    assert spread < 0.2 * s.abs().max(), (spread, s.abs().max())


@pytest.mark.parametrize("dtype,design", [(torch.bfloat16, "mma.sync"),
                                          (torch.float32, "fma")])
def test_bwd_route_is_the_dtypes(dtype, design):
    """The backward's route, by dtype alone (the C entry picks the same):
    bf16 chunk-parallel on the tensor cores, f32 the walk on the CUDA
    cores; reset_launches zeroes its count."""
    assert TO.bwd_design(dtype) == design and design in TO.BWD_DESIGNS
    TO.bwd_design_launches[design] += 1
    TO.reset_launches()
    assert not any(TO.bwd_design_launches.values())
    assert TO.bwd_launches == 0
