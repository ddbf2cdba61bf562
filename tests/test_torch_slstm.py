"""The sLSTM recurrence (``kernels/slstm``): its plain version against the
JAX package's scan and its gradient, the model's sLSTM bit-equal to the
token loop it replaced, the wrapper's routes and checks, and the
analysis route's count.

The plain version (``ref.slstm_scan``) is held against ``jax.lax.scan``
over the JAX package's own ``_slstm_cell`` (the body of
``repro.models.xlstm.slstm_forward``, ``xlstm.py:280-290``) under
``jax.jit``, and its autograd (``ref.slstm_grads``) against ``jax.grad``
of the same scan, for the gradients of gx, r, bf and the initial state.
Inputs come from a numpy seed; both sides run in f32 on the CPU.  The
tolerances: h and the final state atol 1e-5 / rtol 1e-5 (the recurrent
einsum sums hd terms in another order in XLA than in PyTorch, and the
recurrence carries that rounding over L steps); gradients atol 1e-4
times the gradient's largest magnitude (at least 1) / rtol 1e-4 (they sum
the same products over the steps and the batch in other orders).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import xlstm as JX
from repro_torch.configs import registry as treg
from repro_torch.kernels import analysis
from repro_torch.kernels.slstm import ops as SO
from repro_torch.kernels.slstm import ref as SR
from repro_torch.launch import hloanalysis
from repro_torch.models import xlstm as TX
from repro_torch.models.layers import matmul, rms_norm
from repro_torch.weights import params_from_numpy

torch.set_num_threads(2)   # several test workers share the cores

TOL = dict(atol=1e-5, rtol=1e-5)
KEYS = SR.STATE_KEYS


def _inputs(b, length, d, h, seed, state, slow=False):
    """numpy gx (B,L,4d), r (h,hd,4hd) with a scale per head, bf, the
    state (zero, or drawn with n > 0) and the loss's weights dy and the
    final state's dfin."""
    rng = np.random.default_rng(seed)
    hd = d // h
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    gx = f(b, length, 4 * d)
    r = f(h, hd, 4 * hd) * hd ** -0.5 * (1 + np.arange(h, dtype=np.float32)
                                          )[:, None, None]
    bf = (7.0 + np.abs(f(d)) if slow else np.full((d,), 3.0)
          ).astype(np.float32)
    if state:
        st = {"c": f(b, d), "n": (rng.random((b, d)) + 0.5).astype(
            np.float32), "h": f(b, d) * 0.5, "m": f(b, d)}
    else:
        st = {k: np.zeros((b, d), np.float32) for k in ("c", "n", "h")}
        st["m"] = np.full((b, d), SR.NEG, np.float32)
    dy = f(b, length, d)
    dfin = {k: f(b, d) for k in KEYS}
    return gx, r, bf, st, dy, dfin


def _jax_scan(r, bf, gx, st, h):
    """The JAX package's sLSTM scan: ``lax.scan`` over its _slstm_cell."""
    cfg = types.SimpleNamespace(n_heads=h)
    params = {"r": r, "bf": bf}

    def step(s, g):
        s_new = JX._slstm_cell(params, g, s, cfg)
        return s_new, s_new["h"]
    fin, hs = jax.lax.scan(step, st, jnp.moveaxis(gx, 1, 0))
    return jnp.moveaxis(hs, 0, 1), fin


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _grad_close(got, want):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    _close(got, want, atol=1e-4 * scale, rtol=1e-4)


# (B, L, d, h, state, slow): h 4 and 2, ragged lengths, an initial state,
# slow forget gates
CASES = [(2, 16, 64, 4, False, False), (1, 37, 64, 4, True, True),
         (3, 9, 64, 2, True, False), (2, 1, 64, 4, True, False)]


@pytest.mark.parametrize("case", CASES)
def test_plain_scan_matches_jax(case):
    b, length, d, h, state, slow = case
    gx, r, bf, st, _, _ = _inputs(b, length, d, h, length + h, state, slow)
    jy, jfin = jax.jit(_jax_scan, static_argnums=4)(r, bf, gx, st, h)
    ty, tfin = SR.slstm_scan(_t(gx), _t(r), _t(bf),
                             {k: _t(v) for k, v in st.items()}, h)
    _close(ty, jy)
    for key in KEYS:
        _close(tfin[key], jfin[key])


@pytest.mark.parametrize("case", CASES)
def test_plain_grads_match_jax_grad(case):
    """Autograd of the plain scan against ``jax.grad`` of the JAX scan
    under loss = sum(y dy) + sum over the final state of leaf dfin: the
    gradients of gx, r, bf and every initial state leaf."""
    b, length, d, h, state, slow = case
    gx, r, bf, st, dy, dfin = _inputs(b, length, d, h, 2 * length + h,
                                      state, slow)

    def loss(gx, r, bf, st):
        y, fin = _jax_scan(r, bf, gx, st, h)
        return jnp.sum(y * dy) + sum(jnp.sum(fin[k] * dfin[k])
                                     for k in KEYS)
    jg = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(gx, r, bf, st)
    tg = SR.slstm_grads(_t(gx), _t(r), _t(bf),
                        {k: _t(v) for k, v in st.items()}, h, _t(dy),
                        {k: _t(v) for k, v in dfin.items()})
    for name, want in zip(("gx", "r", "bf"), jg[:3]):
        _grad_close(tg[name], want)
    for key in KEYS:
        _grad_close(tg["state"][key], jg[3][key])


def test_keep_returns_each_steps_values():
    """``keep``: g is the cell's preactivation (gx plus the head-major
    recurrent term of the step before's h) and c, n, m the states after
    each step; the final state is the last row."""
    gx, r, bf, st, _, _ = _inputs(2, 6, 64, 4, 1, True)
    st = {k: _t(v) for k, v in st.items()}
    y, fin, hist = SR.slstm_scan(_t(gx), _t(r), _t(bf), st, 4, keep=True)
    h_before = torch.cat([st["h"][:, None], y[:, :-1]], dim=1)
    for t in range(6):
        g = SR.gate_preacts(_t(gx)[:, t], h_before[:, t], _t(r), 4)
        assert torch.equal(hist["g"][:, t], g)
    for key in ("c", "n", "m"):
        assert torch.equal(hist[key][:, -1], fin[key])


# ---------------------------------------------------------------------------
# the model's sLSTM, bit-equal to the token loop it replaced
# ---------------------------------------------------------------------------
def _forward_before(params, x, cfg, state=None):
    """models.xlstm.slstm_forward as it was before the kernels (verbatim,
    with its cell)."""
    bs, length, _ = x.shape
    gx = matmul(x, params["w"]).float()
    st = state or TX.init_slstm_state(cfg, bs, x.dtype, device=x.device)
    r32 = params["r"].float()
    hs = []
    for t in range(length):
        st = _cell_before(params, gx[:, t], st, cfg, r32)
        hs.append(st["h"])
    y = torch.stack(hs, dim=1).to(x.dtype)
    y = rms_norm(params["norm_w"], y, cfg.norm_eps)
    return TX._geglu_out(params, y), st


def _cell_before(params, gx, state, cfg, r32=None):
    if r32 is None:
        r32 = params["r"].float()
    h_heads = state["h"].reshape(gx.shape[0], cfg.n_heads, -1)
    gr = torch.einsum("bhd,hde->bhe", h_heads, r32)
    g = gx + gr.reshape(gx.shape[0], -1)
    gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
    logf = torch.log(torch.sigmoid(gf + params["bf"]) + 1e-9)
    m_new = torch.maximum(logf + state["m"], gi)
    fi = torch.exp(logf + state["m"] - m_new)
    ii = torch.exp(gi - m_new)
    c = fi * state["c"] + ii * torch.tanh(gz)
    n = fi * state["n"] + ii
    hy = torch.sigmoid(go) * c / torch.clamp_min(n, 1e-6)
    return {"c": c, "n": n, "h": hy, "m": m_new}


def _slstm_params(seed=0):
    jcfg = jreg.reduced_config("xlstm-1.3b")
    nps = jax.tree.map(np.asarray, JX.init_slstm(jax.random.PRNGKey(seed),
                                                 jcfg))
    nps["bf"] = (nps["bf"] + np.random.default_rng(seed).standard_normal(
        nps["bf"].shape)).astype(np.float32)
    return treg.reduced_config("xlstm-1.3b"), params_from_numpy(nps, "cpu")


@pytest.mark.parametrize("length,state", [(13, False), (5, True)])
def test_model_forward_bit_equal_to_the_loop_before(length, state):
    cfg, params = _slstm_params()
    x = _t(np.random.default_rng(length).standard_normal(
        (2, length, cfg.d_model)))
    st = None
    if state:
        _, st = _forward_before(params, x, cfg)
    y, fin = TX.slstm_forward(params, x, cfg, st)
    y0, fin0 = _forward_before(params, x, cfg, st)
    assert torch.equal(y, y0)
    for key in KEYS:
        assert torch.equal(fin[key], fin0[key])


def test_model_decode_bit_equal_to_the_cell_before():
    cfg, params = _slstm_params(1)
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((2, 6, cfg.d_model)))
    _, st = _forward_before(params, x, cfg)
    xt = _t(rng.standard_normal((2, 1, cfg.d_model)))
    y, fin = TX.slstm_decode(params, xt, st, cfg)
    gx = matmul(xt[:, 0], params["w"]).float()
    st0 = _cell_before(params, gx, st, cfg)
    y0 = TX._geglu_out(params, rms_norm(params["norm_w"], st0["h"].to(
        xt.dtype), cfg.norm_eps))[:, None]
    assert torch.equal(y, y0)
    for key in KEYS:
        assert torch.equal(fin[key], st0[key])


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
def test_cpu_route_is_the_plain_scan_and_counts_nothing():
    gx, r, bf, st = SR.slstm_inputs(2, 5, 64, 4, seed=2, state=True)
    before = (SO.launches, SO.bwd_launches)
    y, fin = SO.slstm(gx, r, bf, st)
    yr, fr = SR.slstm_scan(gx, r, bf, st, 4)
    assert torch.equal(y, yr)
    assert all(torch.equal(fin[k], fr[k]) for k in KEYS)
    assert (SO.launches, SO.bwd_launches) == before


@pytest.mark.parametrize("bad", ["gx_width", "r_shape", "bf", "state",
                                 "empty"])
def test_wrapper_rejects_bad_shapes(bad):
    gx, r, bf, st = SR.slstm_inputs(2, 5, 64, 4, seed=2)
    if bad == "gx_width":
        gx = gx[..., :-4]
    elif bad == "r_shape":
        r = r[:, :, :-1]
    elif bad == "bf":
        bf = bf[:-1]
    elif bad == "state":
        st = dict(st, n=st["n"][:1])
    else:
        gx = gx[:, :0]
    with pytest.raises(ValueError):
        SO.slstm(gx, r, bf, st)


def _meta(ins):
    gx, r, bf, st = ins
    return (gx.to("meta"), r.to("meta"), bf.to("meta"),
            {k: v.to("meta") for k, v in st.items()})


def test_cuda_route_checks_dtypes_and_devices():
    """The kernel route refuses what the kernel does not take (here on
    meta tensors inside a card trace, which take that route)."""
    gx, r, bf, st = _meta(SR.slstm_inputs(2, 3, 64, 4, seed=0))
    strided = torch.empty((2, 3, 512), device="meta")[..., ::2]
    with hloanalysis.Recorder():
        with pytest.raises(TypeError):
            SO._launch(gx.half(), r, bf, st, False)
        with pytest.raises(TypeError):
            SO._launch(gx, r.half(), bf, st, False)
        with pytest.raises(ValueError):
            SO._launch(strided, r, bf, st, False)


@pytest.mark.parametrize("keep", [False, True])
def test_analysis_route_records_one_call_of_its_work(keep):
    gx, r, bf, st = _meta(SR.slstm_inputs(2, 7, 64, 4, seed=0,
                                          rdtype=torch.bfloat16))
    rec = hloanalysis.Recorder()
    before = SO.launches
    with rec:
        assert analysis.traced(gx)
        y, fin, hist = SO._launch(gx, r, bf, st, keep)
    assert SO.launches == before
    assert y.shape == (2, 7, 64) and (hist is not None) == keep
    flops, nbytes = SO.work(2, 7, 64, 16, 2, keep)
    assert dict(rec.kernels) == {"slstm": {"calls": 1, "launches": 1,
                                           "flops": flops, "bytes": nbytes}}


def test_work_counts_the_bytes_once():
    flops, nbytes = SO.work(2, 7, 64, 16, 2)
    assert flops == 2 * 2 * 7 * 256 * 16
    assert nbytes == (4 * 2 * 7 * 256 + 4 * 2 * 7 * 64 + 4 * 64 * 16 * 2
                      + 4 * 64 + 8 * 4 * 2 * 64)
    assert SO.work(2, 7, 64, 16, 2, True)[1] - nbytes == 4 * 2 * 7 * 448
    flops, nbytes = SO.bwd_work(2, 7, 64, 16, 4)
    assert flops == 2 * 2 * 7 * 256 * 16
    assert nbytes == (4 * 64 * 16 * 4 + 4 * 64 + 3 * 4 * 2 * 64
                      + 4 * 2 * 7 * 256 + 3 * 4 * 2 * 6 * 64
                      + 4 * 2 * 7 * 64 + 4 * 2 * 7 * 256 + 4 * 64
                      + 4 * 4 * 2 * 64)
    assert SO.bwd_work(2, 7, 64, 16, 4, True)[1] - nbytes == 4 * 4 * 2 * 64
