"""The port's collective_codec (plain version, wrapper geometry and the
compress/decompress pair) against the JAX package, bit for bit, at the
shapes of tests/test_kernels.py.  The JAX side runs its jnp reference and,
as its own tests do on the CPU, its Pallas kernel in interpret mode.  The
CUDA kernel itself runs only on a GPU: test_torch_kernels_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.collective_codec import kernel as JK
from repro.kernels.collective_codec import ops as JO
from repro.kernels.collective_codec import ref as JR
from repro.optim import compress as JC
from repro_torch.kernels.collective_codec import ops as TO
from repro_torch.kernels.collective_codec import ref as TR
from repro_torch.optim import compress as TC

torch.set_num_threads(2)   # several test workers share the cores


def _x(seed, shape, ties=False):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if ties:               # equal magnitudes of both signs in every row
        x = np.round(x)
    return x


def _equal(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("k,m", [(8, 16), (8, 128), (16, 1), (24, 33),
                                 (1, 64)])
@pytest.mark.parametrize("ties", [False, True])
def test_chunk_select_ref_bit_exact_to_jax_kernel_and_ref(k, m, ties):
    x = _x(k * 1000 + m, (k, m), ties)
    rows = JK.BLOCK_ROWS if k % JK.BLOCK_ROWS == 0 else 1
    jk = JK.chunk_select(jnp.asarray(x), block_rows=rows, interpret=True)
    jr = JR.chunk_select_ref(jnp.asarray(x))
    tv, tc, trs = TR.chunk_select_ref(torch.from_numpy(x))
    assert tc.dtype == torch.int32
    assert tv.shape == (k, 1) and tc.shape == (k, 1) and trs.shape == (k, m)
    for j in (jk, jr):
        _equal(tv, j[0])
        _equal(tc, j[1])
        _equal(trs, j[2])


def test_chunk_select_nan_row_matches_jax():
    x = _x(5, (4, 6))
    x[1, 3] = np.nan
    jv, jc, jr = JR.chunk_select_ref(jnp.asarray(x))
    tv, tc, tr = TR.chunk_select_ref(torch.from_numpy(x))
    _equal(tv, jv)
    _equal(tc, jc)
    np.testing.assert_array_equal(np.isnan(tr.numpy()), np.isnan(jr))
    assert int(tc[1, 0]) == 6           # no lane equals a NaN maximum


def test_cpu_wrapper_runs_the_plain_version():
    x = torch.from_numpy(_x(6, (24, 33)))
    before = TO.launches
    vals, col, resid = TO.chunk_select(x)
    assert TO.launches == before
    for a, b in zip((vals, col, resid), TR.chunk_select_ref(x)):
        assert torch.equal(a, b)
    out = torch.empty_like(x)
    assert TO.chunk_select(x, out)[2] is out and torch.equal(out, resid)


@pytest.mark.parametrize("n,frac", [(1000, 0.1), (7, 0.3), (4096, 0.05),
                                    (100, 1.0), (1, 0.5), (1 << 17, 0.05),
                                    (1001, 0.05)])
def test_select_codec_bit_exact_to_jax(n, frac):
    vec = _x(n, (n,))
    kw = dict(use_kernel=True, interpret=True) if n >= JO.KERNEL_MIN_SIZE \
        else {}
    jv, ji, jr = JO.select_codec(jnp.asarray(vec), frac=frac, **kw)
    assert TO.codec_geometry(n, frac) == JO.codec_geometry(n, frac)
    tv, ti, tr = TO.select_codec(torch.from_numpy(vec), frac=frac)
    assert ti.dtype == torch.int32
    _equal(tv, jv)
    _equal(ti, ji)
    _equal(tr, jr)
    # error feedback: scatter(vals, idx) + resid is the input exactly
    recon = torch.zeros(n).index_add_(0, ti.long(), tv) + tr
    np.testing.assert_array_equal(recon.numpy(), vec)


def test_select_codec_frac_one_is_identity():
    vec = torch.from_numpy(_x(42, (257,)))
    vals, idx, resid = TO.select_codec(vec, frac=1.0)
    assert torch.equal(idx, torch.arange(257, dtype=torch.int32))
    assert torch.equal(vals, vec) and not resid.any()


@pytest.mark.parametrize("n,frac", [(50, 0.25), (617, 0.05), (64, 1.0)])
def test_select_codec_shards_is_one_select_per_shard(n, frac):
    shards = torch.from_numpy(_x(n, (4, n)))
    out = torch.full((4, n), 7.0)
    vals, idx, resid = TO.select_codec_shards(shards, frac=frac,
                                              out_resid=out)
    assert resid.data_ptr() == out.data_ptr()
    for p in range(4):
        v, i, r = TO.select_codec(shards[p], frac=frac)
        assert torch.equal(vals[p], v) and torch.equal(idx[p], i)
        assert torch.equal(out[p], r)


def test_compress_decompress_match_jax():
    rng = np.random.default_rng(9)
    grads = {"w": rng.normal(size=(6, 20)).astype(np.float32),
             "b": [rng.normal(size=(33,)).astype(np.float32)]}
    resid = {"w": rng.normal(size=(6, 20)).astype(np.float32) * 0.1,
             "b": [rng.normal(size=(33,)).astype(np.float32) * 0.1]}
    jgrads = jax.tree.map(jnp.asarray, grads)
    jsp, jres = JC.compress(jgrads, jax.tree.map(jnp.asarray, resid), 0.2)
    tgrads = jax.tree.map(torch.from_numpy, grads)
    tsp, tres = TC.compress(tgrads, jax.tree.map(torch.from_numpy, resid),
                            0.2)
    for (tv, ti), (jv, ji) in zip([tsp["b"][0], tsp["w"]],
                                  [jsp["b"][0], jsp["w"]]):
        _equal(tv, jv)
        _equal(ti, ji)
    _equal(tres["w"], jres["w"])
    _equal(tres["b"][0], jres["b"][0])
    jd = JC.decompress(jsp, jgrads)
    td = TC.decompress(tsp, tgrads)
    _equal(td["w"], jd["w"])
    _equal(td["b"][0], jd["b"][0])
    assert TC.compression_ratio(tsp, tgrads) == pytest.approx(
        JC.compression_ratio(jsp, jgrads))
    zero = TC.init_residual(tgrads)
    assert zero["w"].dtype == torch.float32 and not zero["w"].any()
