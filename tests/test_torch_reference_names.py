"""The reference functions the JAX package's modules define for its
benchmarks, ported under the same names (``core/diffsync.py``'s
pre-vectorization block, ``core/collectives.reference_topk_select``,
``core/elastic.replicated_shardings``, ``configs/registry.iter_cells``),
against the JAX package's on the same numpy inputs from a seed.

* diffsync's reference block at each merge op over f32, f64, bf16, int32
  and int64 (the dtypes ``tests/test_diffsync.py`` uses), ragged tails
  included, bit for bit; and a tree.
* ``reference_topk_select`` at distinct magnitudes: the same selected
  values, indices and residual (compared as sets of (index, value): tie
  order is the library's).
* ``replicated_shardings`` as the destination of ``migrate_live`` and
  ``migrate_via_snapshot``, bit-exact by ``verify_migration``, written as
  ``benchmarks/bench_migration.py`` writes the calls.
* ``iter_cells``: the 40 (arch, shape, applicable, reason) cells.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import collectives as JC
from repro.core import diffsync as JD
from repro_torch.configs import registry as treg
from repro_torch.configs.registry import reduced_config
from repro_torch.core import collectives as TC
from repro_torch.core import diffsync as TD
from repro_torch.core import migration
from repro_torch.core import snapshot as snap_mod
from repro_torch.core.devices import virtual_devices
from repro_torch.core.elastic import make_dp_mesh, replicated_shardings
from repro_torch.models import model as TM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.weights import params_from_numpy, params_to_numpy

torch.set_num_threads(2)   # several test workers share the cores

NP = {"float32": np.float32, "float64": np.float64,
      "bfloat16": ml_dtypes.bfloat16, "int32": np.int32, "int64": np.int64}
SIZES = (7, 1024, 4000)


def _t(a):
    return params_from_numpy(np.asarray(a), "cpu")


def _same(got, want):
    """Bit for bit (NaNs where NaNs are), as numpy arrays."""
    got = params_to_numpy(got, ml_dtypes.bfloat16) \
        if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
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


def _triple(n, dtype, seed, op):
    """(a0, b0, b1): b1 = b0 with about a ninth of its elements changed;
    integers away from 0 under multiply and divide."""
    rng = np.random.default_rng(seed)
    if dtype.startswith("int"):
        lo = 1 if op in ("multiply", "divide") else -1000
        a0, b0 = (rng.integers(lo, 1000, n).astype(NP[dtype])
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


@pytest.mark.parametrize("dtype", list(NP))
@pytest.mark.parametrize("op", TD.MERGE_OPS)
def test_reference_diff_apply_leaf_match_jax(op, dtype):
    for i, n in enumerate(SIZES):
        a0, b0, b1 = _triple(n, dtype, 100 * i + len(op), op)
        jd = JD.reference_diff_leaf(b0, b1, op=op)
        td = TD.reference_diff_leaf(_t(b0), _t(b1), op=op)
        np.testing.assert_array_equal(td.idx.numpy(), jd.idx)
        _same(td.new, jd.new)
        _same(td.old, jd.old)
        assert (td.shape, td.dtype, td.op) == (tuple(jd.shape),
                                               _t(b0).dtype, jd.op)
        _same(TD.reference_apply_leaf(_t(a0), td),
              JD.reference_apply_leaf(a0, jd))
        _same(TD.reference_merge_scalarwise(_t(a0), _t(b0), _t(b1), op),
              JD.reference_merge_scalarwise(a0, b0, b1, op))


def test_reference_chunk_view_pads_like_jax():
    for n in (1, 1023, 1024, 1025):
        a = np.arange(n, dtype=np.float32)
        _same(TD._chunk_view(_t(a)), JD._chunk_view(a))


def test_reference_apply_tree_matches_jax():
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(80, 33)).astype(np.float32),
            "b": rng.normal(size=(130,)).astype(np.float64),
            "h": rng.normal(size=(40, 70)).astype(ml_dtypes.bfloat16),
            "clean": rng.normal(size=(50,)).astype(np.float32)}
    new = {k: v.copy() for k, v in tree.items()}
    new["w"][5, :] += 1.0
    new["b"][100:] *= 1.5
    new["h"][3, :9] = 2.0
    jdiffs = JD.diff_tree(tree, new)
    jout = JD.reference_apply_tree(tree, jdiffs)
    ttree = {k: _t(v) for k, v in tree.items()}
    tdiffs = {key: TD.reference_diff_leaf(ttree[key[2:-2]],
                                          _t(new[key[2:-2]]))
              for key in jdiffs}
    assert sorted(tdiffs) == sorted(TD.diff_tree(
        ttree, {k: _t(v) for k, v in new.items()}))
    tout = TD.reference_apply_tree(ttree, tdiffs)
    for k in tree:
        _same(tout[k], jout[k])
        assert tout[k] is not ttree[k]        # every leaf re-materialised


@pytest.mark.parametrize("n,frac", [(1000, 0.05), (4096, 0.01), (37, 0.5),
                                    (10, 0.01)])
def test_reference_topk_select_matches_jax(n, frac):
    rng = np.random.default_rng(n)
    # distinct magnitudes: a permutation of 1..n with random signs
    vec = (rng.permutation(n) + 1.0) * rng.choice([-1.0, 1.0], n) / n
    vec = vec.astype(np.float32)
    jsel, jidx, jres = (np.asarray(x) for x in
                        JC.reference_topk_select(jnp.asarray(vec), frac))
    tsel, tidx, tres = TC.reference_topk_select(torch.from_numpy(vec), frac)
    assert len(tidx) == len(jidx) == max(1, int(n * frac))
    assert sorted(zip(tidx.tolist(), tsel.tolist())) == \
        sorted(zip(jidx.tolist(), jsel.tolist()))
    np.testing.assert_array_equal(tres.numpy(), jres)


def test_replicated_shardings_through_migrations():
    """``benchmarks/bench_migration.py``'s calls, on the port: a full
    migration through a snapshot and a delta one, each verified
    bit-exact, and a live copy onto the mesh's device."""
    cfg = reduced_config("llama3.2-1b")
    state = TM.init_train_state(torch.Generator().manual_seed(0), cfg,
                                AdamWConfig(), device="cpu")
    devs = virtual_devices(8, "cpu")
    src, dst = make_dp_mesh(devs[:4]), make_dp_mesh(devs[4:])
    assert replicated_shardings(state, dst) == dst.device
    state = migration.migrate_live(state, replicated_shardings(state, src))
    moved, stats = migration.migrate_via_snapshot(
        "j", 0, state, replicated_shardings(state, dst))
    assert stats["full_bytes"] > 0 and not stats["delta"]
    assert migration.verify_migration(state, moved)
    prior = snap_mod.take("j", 0, state)
    state2 = {"params": dict(state["params"]), "opt": state["opt"]}
    state2["params"]["final_norm"] = state2["params"]["final_norm"] * 1.001
    moved2, stats2 = migration.migrate_via_snapshot(
        "j", 1, state2, replicated_shardings(state, dst), prior=prior)
    assert stats2["delta"] and 0 < stats2["moved_bytes"] < stats["full_bytes"]
    assert migration.verify_migration(state2, moved2)
    live = migration.migrate_live(state2, replicated_shardings(state2, dst))
    assert migration.verify_migration(state2, live)


def test_iter_cells_match_jax():
    def rows(mod):
        return [(arch, shape.name, ok, reason)
                for arch, shape, ok, reason in mod.iter_cells()]
    assert len(rows(treg)) == 40
    assert rows(treg) == rows(jreg)
