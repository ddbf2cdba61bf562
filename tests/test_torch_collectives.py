"""The port's gradient sync over virtual ranks against the JAX package's
``build_tree_allreduce`` on a (2, 4) (pod, data) mesh of 8 host devices,
every mode, the compressed one over several steps with its residual.  The
JAX side runs in a subprocess that forces 8 CPU devices (as
tests/test_dist.py does), so this process keeps its 1-device view."""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as JT
from repro_torch.core import collectives as TC
from repro_torch.weights import params_from_numpy, tree_leaves

torch.set_num_threads(2)   # several test workers share the cores

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PODS, DATA = 2, 4
STEPS = 3                  # compressed steps, residual carried


def _tree(seed):
    """Per-rank trees with a leading rank axis of 8: 197 elements per
    rank, so the flat vector pads to 200 and each shard (50) pads again
    in the codec."""
    rng = np.random.default_rng(seed)
    return {"b": rng.normal(size=(8, 77)).astype(np.float32),
            "a": [rng.normal(size=(8, 40, 3)).astype(np.float32)]}


def _rank_trees(tree):
    return [jax.tree.map(lambda x: torch.from_numpy(x[r].copy()), tree)
            for r in range(PODS * DATA)]


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    path = tmp_path_factory.mktemp("coll") / "out.pkl"
    code = textwrap.dedent(f"""
        import pickle, jax, jax.numpy as jnp, numpy as np
        from repro.core import collectives as C
        from repro.core.compat import make_mesh
        mesh = make_mesh(({PODS}, {DATA}), ("pod", "data"))
        tree = pickle.load(open({str(path)!r} + ".in", "rb"))
        tree = jax.tree.map(jnp.asarray, tree)
        out = {{}}
        for mode in ("flat", "ring", "hierarchical"):
            res, _ = jax.jit(C.build_tree_allreduce(mesh, mode=mode))(tree)
            out[mode] = jax.tree.map(np.asarray, res)
        for frac in (0.25, 1.0):
            f = jax.jit(C.build_tree_allreduce(mesh, mode="compressed",
                                               compress_frac=frac))
            resid = C.init_residual_buffer(
                mesh, jax.tree.map(lambda x: x[0], tree))
            steps = []
            for _ in range({STEPS}):
                res, resid = f(tree, resid)
                steps.append((jax.tree.map(np.asarray, res),
                              np.asarray(resid)))
            out["compressed", frac] = steps
        pickle.dump(out, open({str(path)!r}, "wb"))
        print("ok")
    """)
    with open(str(path) + ".in", "wb") as f:
        pickle.dump(_tree(0), f)
    env = {**os.environ, "PYTHONPATH": SRC,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_tree_close(port, jax_tree, atol=1e-5):
    """The port's single mean tree against every rank's copy of JAX's."""
    jl = jax.tree.leaves(jax_tree)
    tl = tree_leaves(port)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        for r in range(j.shape[0]):
            np.testing.assert_allclose(t.numpy(), j[r], atol=atol, rtol=1e-5)


@pytest.mark.parametrize("mode", ["flat", "ring", "hierarchical"])
def test_tree_sync_matches_jax(jax_results, mode):
    out, resid = TC.tree_sync(_rank_trees(_tree(0)), mode, PODS, DATA)
    assert resid is None
    _assert_tree_close(out, jax_results[mode])


@pytest.mark.parametrize("frac", [0.25, 1.0])
def test_compressed_sync_with_residual_matches_jax(jax_results, frac):
    trees = _rank_trees(_tree(0))
    resid = TC.init_residual_buffer(trees[0], PODS, DATA)
    assert resid.shape == (PODS, 200)
    for step, (jout, jresid) in enumerate(jax_results["compressed", frac]):
        out, new = TC.tree_sync(trees, "compressed", PODS, DATA,
                                compress_frac=frac, resid=resid)
        assert new.data_ptr() == resid.data_ptr()   # replaced in place
        _assert_tree_close(out, jout)
        np.testing.assert_allclose(new.numpy(), jresid, atol=1e-5,
                                   rtol=1e-5, err_msg=f"step {step}")


def test_compressed_frac_one_is_bit_exact_to_hierarchical():
    trees = _rank_trees(_tree(1))
    hier, _ = TC.tree_sync(iter(trees), "hierarchical", PODS, DATA)
    resid = TC.init_residual_buffer(trees[0], PODS, DATA)
    comp, new = TC.tree_sync(iter(trees), "compressed", PODS, DATA,
                             compress_frac=1.0, resid=resid)
    for h, c in zip(tree_leaves(hier), tree_leaves(comp)):
        assert torch.equal(h, c)
    assert not new.any()


def test_modes_agree_and_take_vectors_and_stacks():
    trees = _rank_trees(_tree(2))
    stack = torch.stack([TC.flatten_tree(t)[0] for t in trees])
    ref = stack.mean(0)
    for mode in ("flat", "ring", "hierarchical"):
        out, _ = TC.tree_sync(stack, mode, PODS, DATA)
        torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)
        out, _ = TC.tree_sync(trees, mode, 1, PODS * DATA)  # one pod
        torch.testing.assert_close(TC.flatten_tree(out)[0], ref,
                                   atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="ranks"):
        TC.tree_sync(trees[:-1], "hierarchical", PODS, DATA)
    with pytest.raises(ValueError, match="pods"):
        TC.tree_sync(trees, "compressed", 1, 8, compress_frac=0.5)


def test_flatten_order_is_jax_tree_flatten():
    cfg = jreg.reduced_config("llama3.2-1b").with_(n_layers=2, vocab=128)
    jparams = JT.init_params(jax.random.PRNGKey(0), cfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jleaves = jax.tree.leaves(jparams)
    tleaves = tree_leaves(tparams)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    vec, spec = TC.flatten_tree(tparams, pad_to=8)
    jvec = np.concatenate([np.asarray(x).ravel() for x in jleaves])
    np.testing.assert_array_equal(vec[:jvec.size].numpy(), jvec)
    assert vec.numel() % 8 == 0 and not vec[jvec.size:].any()
    back = TC.unflatten_tree(vec, spec)
    assert list(back) == list(tparams)          # the params' key order
    for a, b in zip(tree_leaves(back), tleaves):
        assert torch.equal(a, b)


def test_unflatten_casts_each_leaf_to_its_dtype():
    tree = {"w": torch.randn(3, 5, dtype=torch.bfloat16),
            "n": torch.randn(4)}
    vec, spec = TC.flatten_tree(tree, pad_to=4)
    assert vec.dtype == torch.float32 and vec.numel() == 20
    back = TC.unflatten_tree(vec * 1.001, spec)
    assert back["w"].dtype == torch.bfloat16 and back["n"].dtype == \
        torch.float32
    assert torch.equal(back["w"], (tree["w"].float() * 1.001).bfloat16())
