"""The port's byte-wise diff protocol (``repro_torch.core.diffsync``)
against the JAX package's (``repro.core.diffsync``) on the same numpy
inputs: merge ops, diff/apply of leaves, N-way merges, trees (paths,
indices and payloads of a carried train state), the copy-on-write fork,
dense masks and the fused pass, for every merge op over f32, bf16 and
int32 with ragged tails; int64 beyond 2^53 and f64 against numpy's
expected values.  Both places where the JAX package's host path and its
kernel path disagree are pinned: the port keeps each path's answer."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import diffsync as JD
from repro.models import model as JM
from repro.optim import adamw as JAW
from repro.configs import registry as jreg
from repro_torch.core import diffsync as TD
from repro_torch.kernels.diff_merge import ops as TO
from repro_torch.weights import (params_from_numpy, params_to_numpy,
                                 state_from_numpy, tree_leaves)

torch.set_num_threads(2)   # several test workers share the cores

OPS = TD.MERGE_OPS
NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
      "int32": np.int32, "float64": np.float64}
SIZES = (1, 7, 1023, 1024, 1025, 4000)


def _t(a):
    return params_from_numpy(np.asarray(a), "cpu")


def _n(t):
    return params_to_numpy(t, ml_dtypes.bfloat16)


def _same(got, want):
    """Bit for bit, NaNs where NaNs are."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (got.dtype, want.dtype, got.shape, want.shape)
    if got.dtype.kind == "f" or got.dtype == ml_dtypes.bfloat16:
        nan = np.isnan(got.astype(np.float64))
        np.testing.assert_array_equal(nan, np.isnan(want.astype(np.float64)))
        bits = {2: np.uint16, 4: np.uint32, 8: np.uint64}[got.itemsize]
        np.testing.assert_array_equal(got.view(bits)[~nan],
                                      want.view(bits)[~nan])
    else:
        np.testing.assert_array_equal(got, want)


def _same_diff(td, jd):
    np.testing.assert_array_equal(td.idx.numpy(), jd.idx)
    _same(_n(td.new), jd.new)
    _same(_n(td.old), jd.old)
    assert td.nbytes == jd.nbytes and td.shape == tuple(jd.shape)
    assert td.op == jd.op


def _pair(n, dtype, seed, op="sum"):
    """(a0, b0, b1): b1 = b0 with about a ninth of its elements changed."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        lo = 1 if op in ("multiply", "divide") else -1000
        a0, b0 = (rng.integers(lo, 1000, n).astype(np.int32)
                  for _ in range(2))
        b1 = b0.copy()
        b1[rng.integers(0, n, max(1, n // 9))] += 7
    else:
        a0, b0 = ((rng.normal(size=n) + 2.0).astype(NP[dtype])
                  for _ in range(2))
        b1 = b0.copy()
        idx = rng.integers(0, n, max(1, n // 9))
        b1[idx] = (rng.normal(size=idx.size) + 3.0).astype(NP[dtype])
    return a0, b0, b1


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32",
                                   "float64"])
def test_merge_scalarwise_matches_jax(op, dtype):
    a0, b0, b1 = _pair(3000, dtype, 1, op)
    _same(_n(TD.merge_scalarwise(_t(a0), _t(b0), _t(b1), op)),
          JD.merge_scalarwise(a0, b0, b1, op))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_diff_and_apply_leaf_match_jax(op, dtype):
    for i, n in enumerate(SIZES):
        a0, b0, b1 = _pair(n, dtype, i, op)
        td, jd = TD.diff_leaf(_t(b0), _t(b1), op=op), \
            JD.diff_leaf(b0, b1, op=op)
        _same_diff(td, jd)
        _same(_n(TD.apply_leaf(_t(a0), td)), JD.apply_leaf(a0, jd))


def test_apply_leaf_empty_passthrough_and_inplace():
    a = torch.arange(5000, dtype=torch.float32)
    assert TD.apply_leaf(a, TD.diff_leaf(a, a.clone())) is a
    b1 = a.clone()
    b1[10:20] += 1
    out = TD.apply_leaf(a, TD.diff_leaf(a.clone(), b1), inplace=True)
    assert out is a and torch.equal(a, b1)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_apply_many_matches_jax(op, dtype):
    n = 9000 + 17                         # ragged tail covered below
    rng = np.random.default_rng(len(op))
    a0, b0, _ = _pair(n, dtype, 3, op)
    jd, td = [], []
    for k in range(4):
        b1 = b0.copy()
        lo = 500 * k + (6000 if k == 3 else 0)
        vals = rng.integers(1, 50, 3000) if dtype == "int32" \
            else rng.uniform(1, 2, 3000)
        b1[lo:lo + 3000] = vals[:b1[lo:lo + 3000].size].astype(NP[dtype])
        jd.append(JD.diff_leaf(b0, b1, op=op))
        td.append(TD.diff_leaf(_t(b0), _t(b1), op=op))
    want = JD.apply_many(a0, jd)
    _same(_n(TD.apply_many(_t(a0), td)), want)
    ip = _t(a0)
    assert TD.apply_many(ip, td, inplace=True) is ip
    _same(_n(ip), want)


def _carried_states(seed=0):
    """A reduced bf16 llama3.2-1b train state from the JAX package and the
    same state one fake step later (a few rows and the step changed), as
    numpy trees and as the port's trees."""
    cfg = jreg.reduced_config("llama3.2-1b").with_(n_layers=2, vocab=128,
                                                   dtype="bfloat16")
    jstate = jax.tree.map(np.asarray, JM.init_train_state(
        jax.random.PRNGKey(seed), cfg, JAW.AdamWConfig()))
    child = jax.tree.map(np.array, jstate)
    child["params"]["embed"][3:5] = (child["params"]["embed"][3:5]
                                     .astype(np.float32) * 2).astype(
        ml_dtypes.bfloat16)
    child["opt"]["m"]["blocks"][0]["mlp"]["w1"][1, 7] += 0.5
    child["opt"]["v"]["final_norm"][-3:] = 1.0
    child["opt"]["step"] = np.int32(1)
    return jstate, child


@pytest.mark.parametrize("op", ["overwrite", "sum"])
def test_diff_tree_keys_indices_payloads_match_jax(op):
    jold, jnew = _carried_states()
    told, tnew = state_from_numpy(jold, "cpu"), state_from_numpy(jnew, "cpu")
    assert isinstance(tnew["opt"]["step"], int)
    jd, td = JD.diff_tree(jold, jnew, op=op), TD.diff_tree(told, tnew, op=op)
    assert list(td) == list(jd) == [
        "['opt']['m']['blocks'][0]['mlp']['w1']", "['opt']['step']",
        "['opt']['v']['final_norm']", "['params']['embed']"]
    for key in jd:
        _same_diff(td[key], jd[key])
    assert TD.diff_nbytes(td) == JD.diff_nbytes(jd)
    assert TD.tree_nbytes(told) == JD.tree_nbytes(jold)
    merged_j = jax.tree.leaves(JD.apply_tree(jold, jd))
    merged_t = TD.apply_tree(told, td)
    assert isinstance(merged_t["opt"]["step"], int)
    for t, j in zip(tree_leaves(merged_t), merged_j):
        _same(_n(t) if isinstance(t, torch.Tensor)
              else np.int32(t), np.asarray(j))
    # untouched leaves pass through as the same objects
    assert merged_t["params"]["final_norm"] is told["params"]["final_norm"]


@pytest.mark.parametrize("op", OPS)
def test_apply_tree_stacks_dtypes_like_jax(op):
    rng = np.random.default_rng(3)
    jt = {"w": rng.uniform(1, 2, (80, 33)).astype(np.float32),
          "b": rng.uniform(1, 2, (130,)).astype(np.float64),
          "h": rng.uniform(1, 2, (2100,)).astype(ml_dtypes.bfloat16),
          "i": rng.integers(1, 9, (1500,)).astype(np.int32),
          "clean": rng.normal(size=(50,)).astype(np.float32)}
    jn = {k: v.copy() for k, v in jt.items()}
    jn["w"][5, :] *= 1.5
    jn["b"][100:] *= 1.5
    jn["h"][-4:] = 3.0
    jn["i"][1024:] *= 2
    tt = {k: _t(v) for k, v in jt.items()}
    jd = JD.diff_tree(jt, jn, op=op)
    td = TD.diff_tree(tt, {k: _t(v) for k, v in jn.items()}, op=op)
    assert list(td) == list(jd)
    got, want = TD.apply_tree(tt, td), JD.apply_tree(jt, jd)
    for k in jt:
        _same(_n(got[k]), want[k])
    assert got["clean"] is tt["clean"]


def test_int64_sum_exact_beyond_2_53():
    a0 = torch.tensor([2 ** 60 + 1, 5], dtype=torch.int64)
    b1 = torch.tensor([2 ** 60 + 4, 5], dtype=torch.int64)
    got = TD.apply_leaf(a0, TD.diff_leaf(a0.clone(), b1, op="sum"))
    assert got.tolist() == [2 ** 60 + 4, 5]
    assert got.tolist() == JD.apply_leaf(
        a0.numpy(), JD.diff_leaf(a0.numpy(), b1.numpy(), op="sum")).tolist()


def test_dense_merge_f64_keeps_precision():
    """The expected values of tests/test_diffsync.py's f64 case, which
    cannot run on a JAX without x64."""
    old = torch.full((2048,), 1.0, dtype=torch.float64)
    new = old + 1e-12
    mask, delta = TD.dense_diff(old, new)
    merged = TD.dense_merge(old, mask, delta, op="sum")
    assert merged.dtype == torch.float64 and torch.equal(merged, new)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_dense_diff_and_merge_match_jax(op, dtype):
    a0, b0, b1 = _pair(3333, dtype, 5, op)
    jmask, jdelta = JD.dense_diff(jnp.asarray(b0), jnp.asarray(b1))
    tmask, tdelta = TD.dense_diff(_t(b0), _t(b1))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    _same(_n(tdelta), np.asarray(jdelta))
    if op in ("multiply", "divide"):        # payload B1 / B0
        jpay = jnp.asarray(b1).astype(jnp.float32) / \
            jnp.asarray(b0).astype(jnp.float32)
        jpay = jnp.pad(jpay, (0, (-jpay.size) % JD.CHUNK)).reshape(
            -1, JD.CHUNK)
        tpay = torch.from_numpy(np.array(jpay))
    elif op == "overwrite":
        jpay = jnp.pad(jnp.asarray(b1), (0, (-b1.size) % JD.CHUNK)).reshape(
            -1, JD.CHUNK)
        tpay = _t(np.asarray(jpay))
    else:
        jpay, tpay = jdelta, tdelta
    want = JD.dense_merge(jnp.asarray(a0), jmask, jpay, op=op)
    _same(_n(TD.dense_merge(_t(a0), tmask, tpay, op=op)), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_tracked_fork_matches_jax(dtype):
    rng = np.random.default_rng(7)
    base = (rng.normal(size=10000) * 100).astype(NP[dtype])
    jf, tf = JD.TrackedFork(base.copy()), TD.TrackedFork(_t(base))
    np.multiply(jf.base[100:3000], 3, out=jf.writable(slice(100, 3000)))
    torch.mul(tf.base[100:3000], 3, out=tf.writable(slice(100, 3000)))
    for f in (jf, tf):
        f[5000] = 9
        f[9999] = -1                        # last (ragged) element
        f[6000:6010] = f[6000:6010]         # written, unchanged
    assert tf.dirty_chunks.tolist() == jf.dirty_chunks.tolist()
    for verify in (False, True):
        _same_diff(tf.diff(op="overwrite", verify=verify),
                   jf.diff(op="overwrite", verify=verify))
    assert torch.equal(tf.base, _t(base))   # the base is never written
    _same(_n(tf[1400:1600]), jf[1400:1600])
    _same(_n(tf[0:10]), jf[0:10])
    child = base.copy()
    child[100:3000] *= 3
    child[5000], child[9999] = 9, -1
    _same(_n(TD.apply_leaf(_t(base), tf.diff())), child)


def test_tracked_fork_verify_drops_clean_writes():
    f = TD.TrackedFork(torch.zeros(4096))
    f[0:1024] = 0.0
    f[2048] = 5.0
    assert f.dirty_chunks.tolist() == [0, 2]
    assert f.diff(op="overwrite", verify=True).idx.tolist() == [2]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_fused_diff_apply_both_paths_match_jax(op, dtype):
    a0, b0, b1 = _pair(64 * 300, dtype, 11, op)
    a0, b0, b1 = (x.reshape(64, 300) for x in (a0, b0, b1))
    for use_kernel in (False, True):
        kw = {"interpret": True} if use_kernel else {}
        jm, jd = JD.fused_diff_apply(a0, b0, b1, op=op, use_kernel=use_kernel,
                                     **kw)
        tm, td = TD.fused_diff_apply(_t(a0), _t(b0), _t(b1), op=op,
                                     use_kernel=use_kernel)
        _same(_n(tm), np.asarray(jm))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_fused_diff_apply_keeps_cpu_leaves_on_the_host_path():
    """Only CUDA leaves of KERNEL_MIN_ELEMS elements or more go to the
    kernel: a CPU leaf of that size takes the host path (float64
    rounding), and nothing launches."""
    n = TD.KERNEL_MIN_ELEMS
    a0, b0, b1 = (torch.from_numpy(x) for x in _pair(n, "float32", 2))
    before = TO.launches
    auto = TD.fused_diff_apply(a0, b0, b1, op="sum")
    host = TD.fused_diff_apply(a0, b0, b1, op="sum", use_kernel=False)
    assert TO.launches == before
    assert torch.equal(auto[0], host[0]) and torch.equal(auto[1], host[1])
    step = TD.fused_diff_apply(4, 4, 5, op="sum")
    assert step[0].item() == 5 and step[1].tolist() == [True]


def test_divide_by_zero_fork_disagreement_is_kept():
    """Reference fact: with b0 == 0 and b1 != 0, divide's host path gives
    a0 / (0 / b1) = +-inf, its kernel path gives a0.  Each port path
    gives its JAX path's answer."""
    a0 = np.full(2048, 3.0, np.float32)
    b0 = np.ones(2048, np.float32)
    b1 = b0.copy()
    b0[5], b1[5] = 0.0, 2.0
    b0[6], b1[6] = 0.0, -2.0
    host = TD.fused_diff_apply(_t(a0), _t(b0), _t(b1), op="divide",
                               use_kernel=False)[0]
    kern = TD.fused_diff_apply(_t(a0), _t(b0), _t(b1), op="divide",
                               use_kernel=True)[0]
    assert host[5].item() == float("inf") and host[6].item() == -float("inf")
    assert kern[5].item() == 3.0 and kern[6].item() == 3.0
    _same(host.numpy(), JD.fused_diff_apply(a0, b0, b1, op="divide",
                                            use_kernel=False)[0])
    _same(kern.numpy(), np.asarray(JD.fused_diff_apply(
        a0, b0, b1, op="divide", use_kernel=True, interpret=True)[0]))


def test_f32_sum_host_rounds_once_kernel_rounds_twice():
    """Reference fact: f32 sum computes in f64 and rounds once on the host
    path, in f32 (B1 - B0 rounded, then the sum) on the kernel path.  At
    a0 = 1, b0 = -2^-50, b1 = 2^-24 the kernel path's B1 - B0 rounds to
    2^-24 and 1 + 2^-24 ties to 1; the host path rounds 1 + 2^-24 + 2^-50
    up to 1 + 2^-23.  Where B1 - B0 cancels the two paths can differ by
    more than one ulp.  Each port path equals its JAX path bit for bit."""
    a0, b0, b1 = _pair(8192, "float32", 4)
    a0[0], b0[0], b1[0] = 1.0, -2.0 ** -50, 2.0 ** -24
    host = TD.fused_diff_apply(_t(a0), _t(b0), _t(b1), op="sum",
                               use_kernel=False)[0].numpy()
    kern = TD.fused_diff_apply(_t(a0), _t(b0), _t(b1), op="sum",
                               use_kernel=True)[0].numpy()
    assert host[0] == np.float32(1 + 2.0 ** -23) and kern[0] == 1.0
    _same(host, JD.fused_diff_apply(a0, b0, b1, op="sum",
                                    use_kernel=False)[0])
    _same(kern, np.asarray(JD.fused_diff_apply(a0, b0, b1, op="sum",
                                               use_kernel=True,
                                               interpret=True)[0]))
    assert (host != kern).sum() > 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("size", SIZES)
def test_leaf_diff_from_the_kernels_mask_equals_diff_leaf(dtype, size):
    """The LeafDiff a live CUDA leaf gets (dirty chunks from the
    diff_merge kernel, then rows gathered) is ``diff_leaf``'s: built here
    from the plain version's mask on the same inputs."""
    from repro_torch.kernels.diff_merge import ref as TR
    rng = np.random.default_rng(size)
    old = _t(rng.standard_normal(size).astype(NP[dtype]) * 8)
    new = old.clone()
    if size > 3:
        new[size // 3] += 1
    new[-1] += 1
    mask = TR.diff_merge_leaf_ref(old, old, new, op="overwrite")[1]
    got = TD.leaf_diff_from_mask(old, new, mask, "overwrite")
    want = TD.diff_leaf(old, new, op="overwrite")
    for f in ("idx", "new", "old"):
        assert torch.equal(getattr(got, f), getattr(want, f))
    assert got.shape == want.shape and got.dtype == want.dtype


def test_numpy_leaves_diff_and_apply_as_numpy():
    """A serving state's slot bookkeeping is numpy on the host: diffed as
    CPU tensors over its memory, and given back as numpy by apply_tree."""
    old = {"plen": np.arange(2000, dtype=np.int32),
           "w": torch.zeros(3000)}
    new = {"plen": old["plen"].copy(), "w": old["w"].clone()}
    new["plen"][1500] = -1
    diffs = TD.diff_tree(old, new)
    assert list(diffs) == ["['plen']"]
    merged = TD.apply_tree(old, diffs)
    assert isinstance(merged["plen"], np.ndarray)
    assert np.array_equal(merged["plen"], new["plen"])
    assert old["plen"][1500] == 1500           # the main tree is untouched
    assert TD.tree_nbytes(old) == 2000 * 4 + 3000 * 4
