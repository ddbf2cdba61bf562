"""The port's diff_merge plain version and CPU wrapper against the JAX
package's Pallas kernel (``kernel.diff_merge`` and ``ops.diff_merge_leaf``
in interpret mode) and its oracle ``ref.diff_merge_ref``, on the same
numpy inputs: bit-exact, every merge op, f32, bf16 and int32, ragged
leaves, NaN and -0 chunks, the int32 clean-chunk rounding of multiply and
divide, and float-to-int saturation.  f64 and int64 (which JAX without
x64 cannot run) are held against numpy's expected values.  The CUDA
kernel itself is held against the same plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.diff_merge import kernel as JK
from repro.kernels.diff_merge import ops as JO
from repro.kernels.diff_merge import ref as JR
from repro_torch.kernels.diff_merge import ops as TO
from repro_torch.kernels.diff_merge import ref as TR
from repro_torch.weights import params_from_numpy, params_to_numpy

torch.set_num_threads(2)   # several test workers share the cores

OPS = TR.MERGE_OPS
NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
      "int32": np.int32}


def _t(a):
    return params_from_numpy(np.asarray(a), "cpu")


def _n(t):
    return params_to_numpy(t, ml_dtypes.bfloat16)


def _same(got, want):
    """Bit for bit, NaNs where NaNs are (their payloads may differ)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f" or got.dtype == ml_dtypes.bfloat16:
        nan = np.isnan(got.astype(np.float32))
        np.testing.assert_array_equal(nan, np.isnan(want.astype(np.float32)))
        bits = np.uint16 if got.itemsize == 2 else np.uint32
        np.testing.assert_array_equal(got.view(bits)[~nan],
                                      want.view(bits)[~nan])
    else:
        np.testing.assert_array_equal(got, want)


def _inputs(shape, dtype, op, seed):
    """a0, b0 (independent of a0) and b1 = b0 with some chunks changed."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        lo = 1 if op in ("multiply", "divide") else -2 ** 20
        a0, b0 = (rng.integers(lo, 2 ** 20, shape).astype(np.int32)
                  for _ in range(2))
        b1 = b0.copy()
        flat = b1.reshape(-1)
        flat[:: 97] *= 3
        flat[5:40] += 7
    else:
        a0, b0 = ((rng.normal(size=shape) + 2.0).astype(NP[dtype])
                  for _ in range(2))
        b1 = b0.copy()
        flat = b1.reshape(-1)
        flat[:: 97] = (flat[:: 97].astype(np.float32) * 1.25).astype(
            NP[dtype])
        flat[5:40] = (rng.normal(size=35) + 3.0).astype(NP[dtype])
    return a0, b0, b1


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_ref_matches_pallas_kernel_bit_exact(op, dtype):
    a0, b0, b1 = _inputs((32, 1024), dtype, op, seed=len(op))
    b1[30] = b0[30]                       # clean chunks too
    b1[31] = b0[31]
    ja = [jnp.asarray(x) for x in (a0, b0, b1)]
    jout, jdirty = JK.diff_merge(*ja, op=op, interpret=True)
    rout, rdirty = JR.diff_merge_ref(*ja, op=op)
    tout, tdirty = TR.diff_merge_ref(_t(a0), _t(b0), _t(b1), op=op)
    _same(_n(tout), np.asarray(jout))
    _same(_n(tout), np.asarray(rout))
    np.testing.assert_array_equal(tdirty.numpy(), np.asarray(jdirty))
    assert int(tdirty.sum()) == int(np.asarray(rdirty).sum()) > 0
    assert not tdirty[30:].any()


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("shape", [(13, 77), (3333,)])
def test_leaf_wrapper_matches_jax_ops_ragged(op, dtype, shape):
    a0, b0, b1 = _inputs(shape, dtype, op, seed=shape[0])
    before = TO.launches
    m, d = TO.diff_merge_leaf(_t(a0), _t(b0), _t(b1), op=op)
    jm, jd = JO.diff_merge_leaf(*(jnp.asarray(x) for x in (a0, b0, b1)),
                                op=op, interpret=True)
    assert TO.launches == before          # a CPU tensor: the plain version
    assert m.shape == a0.shape and m.dtype == _t(a0).dtype
    _same(_n(m), np.asarray(jm))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_nan_is_dirty_and_signed_zero_is_clean():
    a0 = np.ones((4, 1024), np.float32)
    b0 = np.zeros((4, 1024), np.float32)
    b1 = b0.copy()
    b1[0, 7] = -0.0                       # -0 vs +0: clean
    b0[1, 9] = b1[1, 9] = np.nan          # NaN in both: dirty
    b1[2, 3] = np.nan                     # NaN in the child: dirty
    for op in OPS:
        tout, tdirty = TR.diff_merge_ref(_t(a0), _t(b0), _t(b1), op=op)
        jout, jdirty = JK.diff_merge(*(jnp.asarray(x) for x in (a0, b0, b1)),
                                     op=op, interpret=True)
        assert tdirty[:, 0].tolist() == [False, True, True, False]
        np.testing.assert_array_equal(tdirty.numpy(), np.asarray(jdirty))
        _same(_n(tout), np.asarray(jout))


@pytest.mark.parametrize("op", ["multiply", "divide"])
def test_int32_clean_chunks_round_through_f32(op):
    """A reference fact the port mirrors: multiply and divide run int32
    leaves in f32, and clean chunks pass through that cast too, so values
    above 2^24 round even where nothing changed."""
    a0 = np.full((2, 1024), 2 ** 24 + 1, np.int32)
    b0 = np.full((2, 1024), 4, np.int32)
    b1 = b0.copy()
    b1[1, 0] = 8
    tout, tdirty = TR.diff_merge_ref(_t(a0), _t(b0), _t(b1), op=op)
    jout, _ = JK.diff_merge(*(jnp.asarray(x) for x in (a0, b0, b1)), op=op,
                            interpret=True)
    assert tdirty[:, 0].tolist() == [False, True]
    assert (tout[0] == 2 ** 24).all()     # clean, yet rounded
    _same(tout.numpy(), np.asarray(jout))


def test_float_to_int_saturates_as_xla():
    a0 = np.array([[2 ** 30, -2 ** 30, 5] + [1] * 1021], np.int32)
    b0 = np.ones_like(a0)
    b1 = b0 * 8
    tout, _ = TR.diff_merge_ref(_t(a0), _t(b0), _t(b1), op="multiply")
    jout, _ = JK.diff_merge(*(jnp.asarray(x) for x in (a0, b0, b1)),
                            op="multiply", interpret=True)
    assert tout[0, :3].tolist() == [2 ** 31 - 1, -2 ** 31, 40]
    _same(tout.numpy(), np.asarray(jout))
    x = torch.tensor([float("nan"), 3e9, -3e9, -2.7, 2.7])
    assert TR.to_leaf_dtype(x, torch.int32).tolist() == \
        [0, 2 ** 31 - 1, -2 ** 31, -2, 2]


def test_f64_keeps_precision():
    """The expected values of tests/test_kernels.py's f64 case, which
    cannot run on a JAX without x64."""
    a0 = torch.full((3000,), 1.0, dtype=torch.float64)
    b0 = a0.clone()
    b1 = b0.clone()
    b1[:1024] += 1e-12
    m, d = TO.diff_merge_leaf(a0, b0, b1, op="sum")
    assert m.dtype == torch.float64
    assert torch.equal(m, b1) and int(d.sum()) == 1
    assert d.tolist() == [True, False, False]


@pytest.mark.parametrize("op", ["sum", "subtract", "overwrite"])
def test_int64_exact_beyond_2_53(op):
    base = np.int64(2 ** 60)
    a0 = base + np.arange(3000, dtype=np.int64)
    b0 = base - np.arange(3000, dtype=np.int64)
    b1 = b0.copy()
    b1[1500:1600] += 3
    m, d = TO.diff_merge_leaf(*(torch.from_numpy(x) for x in (a0, b0, b1)),
                              op=op)
    want = a0.copy()
    if op == "overwrite":
        want[1024:2048] = b1[1024:2048]
    else:
        want[1024:2048] += (b1 - b0)[1024:2048]
    np.testing.assert_array_equal(m.numpy(), want)
    assert d.tolist() == [False, True, False]


def test_wrapper_rejects_what_it_cannot_take():
    x = torch.zeros(2048)
    with pytest.raises(ValueError, match="op"):
        TO.diff_merge_leaf(x, x, x, op="max")
    with pytest.raises(ValueError, match="shape"):
        TO.diff_merge_leaf(x, x, torch.zeros(1024), op="sum")
    with pytest.raises(ValueError, match="dtype"):
        TO.diff_merge_leaf(x, x, x.double(), op="sum")
    with pytest.raises(TypeError, match="CUDA"):
        TO._launch(x, x, x, "sum")        # the kernel takes no CPU tensor
