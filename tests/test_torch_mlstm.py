"""The port's mlstm plain version (the stabilised chunkwise mLSTM) and
wrapper against the JAX package: its Pallas kernel in interpret mode and
its wrapper, its exact per-token oracle ``ref.mlstm_ref``, and
``models.xlstm.mlstm_chunked`` (ragged tails, an initial state, chunk
invariance), on the same numpy inputs.  Tolerances: the JAX kernel test's
own (tests/test_kernels.py:226-244), h and C atol 1e-4 / rtol 1e-3, the
log-domain stabiliser m atol 1e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm import kernel as JK
from repro.kernels.mlstm import ops as JO
from repro.kernels.mlstm import ref as JR
from repro.models import xlstm as JX
from repro_torch.kernels.mlstm import ops as TO
from repro_torch.kernels.mlstm import ref as TR

torch.set_num_threads(2)   # several test workers share the cores

TOL = dict(atol=1e-4, rtol=1e-3)
M_TOL = dict(atol=1e-3, rtol=0)


# Forget gates (sign, mean, std of x): "jax" is the JAX kernel test's
# logf = -softplus(x), about -0.8 a token, under which nothing of C
# outlives a chunk; "model" is log sigmoid(x) with the model's forget
# bias of 3; "slow" is log sigmoid(x) at about -0.01, so that C and n
# carry over several chunks.
GATES = {"jax": (-1.0, 0.0, 1.0), "model": (1.0, 3.0, 1.0),
         "slow": (1.0, 4.6, 0.1)}


def _inputs(b, length, h, hd, seed, state=False, gates="jax"):
    """Model layout: q, k, v (B,L,H,hd); logi, logf (B,L,H), by default
    as the JAX kernel test draws them; optionally a nonzero initial
    state."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, length, h, hd)).astype(np.float32)
               for _ in range(3))
    li = (rng.standard_normal((b, length, h)) - 1).astype(np.float32)
    sign, mean, std = GATES[gates]
    x = rng.standard_normal((b, length, h)) * std + mean
    lf = (-np.log1p(np.exp(x)) if sign < 0
          else -np.log1p(np.exp(-x))).astype(np.float32)
    st = None
    if state:
        st = ((rng.standard_normal((b, h, hd, hd)) * 0.3).astype(np.float32),
              (rng.standard_normal((b, h, hd)) * 0.3).astype(np.float32),
              rng.standard_normal((b, h)).astype(np.float32))
    return (q, k, v, li, lf), st


def _t(arrays):
    return tuple(None if a is None else torch.from_numpy(a) for a in arrays)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


# the JAX kernel test's shapes (b, h, l, hd, chunk)
KERNEL_SHAPES = [(2, 2, 128, 32, 32), (1, 4, 256, 64, 64),
                 (2, 1, 64, 16, 16)]


@pytest.mark.parametrize("b,h,length,hd,chunk", KERNEL_SHAPES)
def test_plain_matches_jax_kernel_and_oracle(b, h, length, hd, chunk):
    (q, k, v, li, lf), _ = _inputs(b, length, h, hd, b * length + h)
    ht, (c, n, m) = TR.mlstm_chunked(*_t((q, k, v, li, lf)), chunk=chunk)
    assert ht.shape == q.shape and ht.dtype == torch.float32
    assert c.shape == (b, h, hd, hd) and n.shape == (b, h, hd)
    assert m.shape == (b, h)
    kl = lambda x: np.moveaxis(x, 2, 1)        # (B,H,L,...) kernel layout
    jh, jc, jn, jm = JK.mlstm_scan(kl(q), kl(k), kl(v), kl(li)[..., None],
                                   kl(lf)[..., None], chunk=chunk,
                                   interpret=True)
    eh, (ec, en, em) = JR.mlstm_ref(kl(q), kl(k), kl(v), kl(li)[..., None],
                                    kl(lf)[..., None])
    for wh, wc, wn, wm in ((jh, jc, jn, jm), (eh, ec, en, em)):
        _close(ht, np.moveaxis(np.asarray(wh), 1, 2))
        _close(c, wc)
        _close(n, np.asarray(wn)[:, :, 0])
        _close(m, np.asarray(wm)[:, :, 0, 0], M_TOL)


@pytest.mark.parametrize("b,h,length,hd,chunk", KERNEL_SHAPES)
def test_wrapper_matches_jax_ops_and_mlstm_chunked(b, h, length, hd, chunk):
    (q, k, v, li, lf), _ = _inputs(b, length, h, hd, length + hd)
    before = TO.launches
    ht, st = TO.mlstm(*_t((q, k, v, li, lf)), chunk=chunk)
    assert TO.launches == before          # the CPU runs the plain version
    jh, jst = JO.mlstm(q, k, v, li, lf, chunk=chunk, interpret=True)
    rh, rst = JX.mlstm_chunked(*(jnp.asarray(a) for a in (q, k, v, li, lf)),
                               chunk=chunk)
    for wh, wst in ((jh, jst), (rh, rst)):
        _close(ht, wh)
        _close(st[0], wst[0])
        _close(st[1], wst[1])
        _close(st[2], wst[2], M_TOL)


@pytest.mark.parametrize("length,chunk", [(100, 32), (37, 16), (130, 128)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ragged_tail_and_initial_state_match_jax_mlstm_chunked(
        length, chunk, with_state):
    """A last chunk shorter than the others (which the JAX Pallas kernel
    refuses, kernel.py:98-99) and a nonzero initial state (which its
    path drops, xlstm.py:186-188): the plain version and the wrapper
    agree with the JAX model path, which takes both."""
    (q, k, v, li, lf), st = _inputs(2, length, 2, 16, length + chunk,
                                    with_state)
    tst = None if st is None else _t(st)
    ht, (c, n, m) = TO.mlstm(*_t((q, k, v, li, lf)), tst, chunk=chunk)
    jst = None if st is None else tuple(jnp.asarray(a) for a in st)
    jh, (jc, jn, jm) = JX.mlstm_chunked(
        *(jnp.asarray(a) for a in (q, k, v, li, lf)), jst, chunk=chunk)
    _close(ht, jh)
    _close(c, jc)
    _close(n, jn)
    _close(m, jm, M_TOL)


@pytest.mark.parametrize("gates", ["model", "slow"])
@pytest.mark.parametrize("with_state", [False, True])
def test_forget_gates_that_carry_c_match_jax(gates, with_state):
    """Forget gates as the model draws them and slower ones, under which
    C and n carry over several chunks (the JAX test's gates forget a
    chunk within ~20 tokens): the wrapper agrees with the JAX model path
    and, from the zero state, with the exact per-token oracle."""
    (q, k, v, li, lf), st = _inputs(2, 300, 2, 32, 11, with_state, gates)
    tst = None if st is None else _t(st)
    ht, (c, n, m) = TO.mlstm(*_t((q, k, v, li, lf)), tst, chunk=64)
    jst = None if st is None else tuple(jnp.asarray(a) for a in st)
    jh, (jc, jn, jm) = JX.mlstm_chunked(
        *(jnp.asarray(a) for a in (q, k, v, li, lf)), jst, chunk=64)
    _close(ht, jh)
    _close(c, jc)
    _close(n, jn)
    _close(m, jm, M_TOL)
    if st is None:
        kl = lambda x: np.moveaxis(x, 2, 1)
        eh, (ec, _, _) = JR.mlstm_ref(kl(q), kl(k), kl(v), kl(li)[..., None],
                                      kl(lf)[..., None])
        _close(ht, np.moveaxis(np.asarray(eh), 1, 2))
        _close(c, ec)
    if gates == "slow":     # the earlier chunks weigh in the final C
        _, (c1, _, m1) = TO.mlstm(*_t((q[:, 256:], k[:, 256:], v[:, 256:],
                                       li[:, 256:], lf[:, 256:])), chunk=64)
        top = m.amax()
        full = c * (m - top)[..., None, None].exp()
        last = c1 * (m1 - top)[..., None, None].exp()
        assert (full - last).abs().max() > 0.1 * full.abs().max()


def test_chunk_invariance_and_jax_default_chunk():
    """The mirror of tests/test_model_math.py:105: chunks of 64, 16 and 1
    (the pure recurrence) agree, and the kernel's chunk of 128 agrees with
    the JAX model path's 1024 to tolerance (not bit for bit)."""
    (q, k, v, li, lf), _ = _inputs(2, 200, 2, 16, 7)
    tin = _t((q, k, v, li, lf))
    o1, s1 = TR.mlstm_chunked(*tin, chunk=64)
    for chunk in (1, 16, 128):
        o2, s2 = TR.mlstm_chunked(*tin, chunk=chunk)
        np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-4)
        np.testing.assert_allclose(s1[0].numpy(), s2[0].numpy(), atol=1e-4)
    o3, s3 = TO.mlstm(*tin)                       # the model's chunk, 128
    jo, js = JX.mlstm_chunked(*(jnp.asarray(a) for a in (q, k, v, li, lf)))
    _close(o3, jo)
    _close(s3[0], js[0])


def test_state_carries_a_split_sequence():
    """Scanning the first part, then the rest from its final state, equals
    scanning the whole: the initial state is taken exactly."""
    (q, k, v, li, lf), _ = _inputs(1, 96, 2, 32, 3)
    tin = _t((q, k, v, li, lf))
    whole, st_w = TO.mlstm(*tin, chunk=32)
    first, st1 = TO.mlstm(*(t[:, :40] for t in tin), chunk=32)
    rest, st2 = TO.mlstm(*(t[:, 40:] for t in tin), st1, chunk=32)
    np.testing.assert_allclose(torch.cat([first, rest], 1).numpy(),
                               whole.numpy(), **TOL)
    for a, b in zip(st2, st_w):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_bf16_inputs_scan_in_f32_and_round_h_once():
    (q, k, v, li, lf), _ = _inputs(1, 48, 2, 16, 5)
    qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    lit, lft = torch.from_numpy(li), torch.from_numpy(lf)
    h, st = TR.mlstm_chunked(qb, kb, vb, lit, lft, chunk=16)
    h32, st32 = TR.mlstm_chunked(qb.float(), kb.float(), vb.float(), lit,
                                 lft, chunk=16)
    assert h.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in st)
    assert torch.equal(h, h32.bfloat16())
    for a, b in zip(st, st32):
        assert torch.equal(a, b)


def test_wrapper_rejects_bad_shapes():
    (q, k, v, li, lf), st = _inputs(1, 32, 2, 16, 1, state=True)
    q, k, v, li, lf = _t((q, k, v, li, lf))
    c, n, m = _t(st)
    with pytest.raises(ValueError, match="shapes"):
        TO.mlstm(q, k[:, :16], v, li, lf)
    with pytest.raises(ValueError, match="shapes"):
        TO.mlstm(q, k, v, li[..., :1], lf)
    with pytest.raises(ValueError, match="state shapes"):
        TO.mlstm(q, k, v, li, lf, (c, n[..., :8], m))
    with pytest.raises(ValueError, match=r"\(B,L,H,hd\)"):
        TO.mlstm(q[0], k[0], v[0], li[0], lf[0])


def test_jax_pallas_path_drops_the_state_and_needs_whole_chunks():
    """Facts of the JAX package the port does not copy: its Pallas wrapper
    has no state argument and its kernel asserts L % chunk == 0."""
    (q, k, v, li, lf), _ = _inputs(1, 40, 1, 16, 2)
    with pytest.raises(TypeError):
        JO.mlstm(q, k, v, li, lf, (None, None, None), chunk=16,
                 interpret=True)
    with pytest.raises(AssertionError):
        JO.mlstm(q, k, v, li, lf, chunk=16, interpret=True)
    ht, _ = TO.mlstm(*_t((q, k, v, li, lf)), chunk=16)    # the port takes it
    assert ht.shape == q.shape
    assert jax.default_backend() == "cpu"


# Gradients: the backward kernel's oracle (ref.mlstm_chunked_grads,
# autograd of the plain version from the zero state) and the wrapper's
# gradient on the CPU against jax.grad of models.xlstm.mlstm_chunked.
# Tolerance: each gradient within rtol 1e-3 and an atol of 1e-4 times its
# largest magnitude (f32 sums over hd or the chunk in another order).
GRAD_NAMES = ("dq", "dk", "dv", "dlogi", "dlogf")
LOGI_SHIFT = {"random": 0.0, "floor": -6.0}    # as ref.grad_inputs


def _grad_close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=1e-3,
                               atol=1e-4 * max(1.0, np.abs(j).max()))


@pytest.mark.parametrize("gates,inputs", [
    ("jax", "random"), ("model", "random"), ("slow", "random"),
    ("slow", "floor")])
@pytest.mark.parametrize("b,h,length,hd,chunk", [
    (2, 2, 100, 32, 32), (1, 2, 64, 16, 16)])
def test_grads_match_jax_grad(b, h, length, hd, chunk, gates, inputs):
    """Rows on both sides of the floor: with slow gates and logi ~ N(-1,
    1) the floor binds on few rows, with logi shifted by -6 on most; the
    first shape has a ragged last chunk."""
    (q, k, v, li, lf), _ = _inputs(b, length, h, hd, length + hd,
                                   gates=gates)
    li = (li + LOGI_SHIFT[inputs]).astype(np.float32)
    dh = np.random.default_rng(7).standard_normal(q.shape).astype(
        np.float32)
    ins = (q, k, v, li, lf)

    def loss(*args):
        out, _ = JX.mlstm_chunked(*args, None, chunk)
        return jnp.sum(out * dh)
    jg = jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, ins))
    tins = _t(ins)
    oracle = TR.mlstm_chunked_grads(*tins, chunk, torch.from_numpy(dh))
    leaves = [t.clone().requires_grad_() for t in tins]
    out, _ = TO.mlstm(*leaves, chunk=chunk)
    wrapper = torch.autograd.grad(out, leaves, torch.from_numpy(dh))
    for name, o, w, j in zip(GRAD_NAMES, oracle, wrapper, jg):
        assert o.shape == tuple(j.shape), name
        _grad_close(o, j)
        _grad_close(w, j)
    share = TR.floor_share(*tins, chunk)
    if gates == "slow":
        assert share > 0.5 if inputs == "floor" else share < 0.5, share


@pytest.mark.parametrize("gates", ["slow", "model"])
def test_common_part_grads_match_jax_grad(gates):
    """The backward kernel's common-part inputs (ref.grad_inputs with
    inputs "common": v around MLSTM_COMMON, dh without its mean over hd,
    so the states C's common part cancels in U = dH C): the oracle
    against jax.grad, and the state's rows do share a large common part."""
    q, k, v, li, lf, dh = TR.grad_inputs(1, 100, 2, 32, gates=gates,
                                         inputs="common", seed=4)
    ins = tuple(t.numpy() for t in (q, k, v, li, lf))

    def loss(*args):
        out, _ = JX.mlstm_chunked(*args, None, 32)
        return jnp.sum(out * dh.numpy())
    jg = jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, ins))
    oracle = TR.mlstm_chunked_grads(q, k, v, li, lf, 32, dh)
    for name, o, j in zip(GRAD_NAMES, oracle, jg):
        _grad_close(o, j)
    _, (c, _, _) = TR.mlstm_chunked(q, k, v, li, lf, None, 32)
    spread = (c - c.mean(2, keepdim=True)).abs().max()
    assert spread < 0.2 * c.abs().max(), (spread, c.abs().max())


@pytest.mark.parametrize("dtype,design", [(torch.bfloat16, "mma.sync"),
                                          (torch.float32, "fma")])
def test_bwd_route_is_the_dtypes(dtype, design):
    """The backward's route, by dtype alone (the C entry picks the same):
    bf16 products on the tensor cores, f32 on the CUDA cores;
    reset_launches zeroes its count."""
    assert TO.bwd_design(dtype) == design and design in TO.BWD_DESIGNS
    TO.bwd_design_launches[design] += 1
    TO.reset_launches()
    assert not any(TO.bwd_design_launches.values())
    assert TO.bwd_launches == 0
