"""The port's partition specs (``models.shardings``: tuples) against the
JAX package's ``PartitionSpec`` trees, spec by spec, for all ten
architectures on both production meshes with FSDP off and on; and the
port's twin of tests/test_model_math.py's divisibility checks."""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jreg
from repro.configs.base import SHAPES as JSHAPES
from repro.models import model as JM
from repro.models import shardings as JSH
from repro.optim.adamw import AdamWConfig as JAdamW
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as TM
from repro_torch.models import shardings as SH
from repro_torch.optim.adamw import AdamWConfig

torch.set_num_threads(2)   # several test workers share the cores

ARCHS = list(treg.ARCH_IDS)
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


class _FakeMesh:
    """tests/test_model_math.py's stand-in for a JAX mesh."""
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes


def _jax_specs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _meshes(shape, axes):
    port = make_production_mesh(multi_pod=len(shape) == 3)
    assert (port.axis_names, tuple(port.shape.values())) == (axes, shape)
    return port, _FakeMesh(shape, axes)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh_shape,axes", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_pspecs_match_jax(arch, mesh_shape, axes, fsdp):
    tcfg = treg.get_config(arch).with_(fsdp=fsdp)
    jcfg = jreg.get_config(arch).with_(fsdp=fsdp)
    tmesh, jmesh = _meshes(mesh_shape, axes)
    assert SH.dp_axes(tmesh) == JSH.dp_axes(jmesh)
    got = SH.spec_leaves(SH.param_pspecs(tcfg, TM.param_specs(tcfg), tmesh))
    want = _jax_specs(JSH.param_pspecs(jcfg, JM.param_specs(jcfg), jmesh))
    assert got == want
    tstate = SH.state_pspecs(
        tcfg, TM.train_state_specs(tcfg, AdamWConfig()), tmesh)
    jstate = JSH.state_pspecs(
        jcfg, JM.train_state_specs(jcfg, JAdamW()), jmesh)
    assert SH.spec_leaves(tstate) == _jax_specs(jstate)


@pytest.mark.parametrize("mesh_shape,axes", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_decode_pspecs_match_jax(arch, mesh_shape, axes):
    tcfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    tmesh, jmesh = _meshes(mesh_shape, axes)
    for name in ("train_4k", "prefill_32k"):
        got = SH.batch_pspecs(tcfg, TM.batch_specs(tcfg, SHAPES[name]),
                              tmesh)
        want = JSH.batch_pspecs(jcfg, JM.batch_specs(jcfg, JSHAPES[name]),
                                jmesh)
        assert {k: v for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
    names = ["decode_32k"] + (["long_500k"] if tcfg.is_subquadratic()
                              else [])
    for name in names:
        got = SH.decode_state_pspecs(
            tcfg, TM.decode_state_specs(tcfg, SHAPES[name]), tmesh)
        want = JSH.decode_state_pspecs(
            jcfg, JM.decode_state_specs(jcfg, JSHAPES[name]), jmesh)
        assert SH.spec_leaves(got) == _jax_specs(want)
        got = SH.batch_pspecs(tcfg, TM.decode_input_specs(
            tcfg, SHAPES[name]), tmesh)
        want = JSH.batch_pspecs(jcfg, JM.decode_input_specs(
            jcfg, JSHAPES[name]), jmesh)
        assert got == {k: tuple(v) for k, v in want.items()}


def _divides(leaf, spec, mesh):
    for dim, ax in zip(leaf.shape, spec):
        names = ax if isinstance(ax, tuple) else (ax,)
        n = 1
        for a in names:
            if a is not None:
                n *= mesh.shape[a]
        if dim % n:
            return False
    return len(spec) == leaf.dim()


@pytest.mark.parametrize("mesh_shape,axes", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_divisible(arch, mesh_shape, axes):
    """Every sharded dim of every param divides by its axes' sizes."""
    cfg = treg.get_config(arch).with_(fsdp=True)
    mesh, _ = _meshes(mesh_shape, axes)
    shapes = TM.param_specs(cfg)
    specs = SH.param_pspecs(cfg, shapes, mesh)
    pairs = list(zip(SH.leaves_with_keys(shapes), SH.spec_leaves(specs)))
    assert len(pairs) == len(SH.spec_leaves(specs))
    bad = [(keys, tuple(leaf.shape), spec) for (keys, leaf), spec in pairs
           if not _divides(leaf, spec, mesh)]
    assert not bad, bad


@pytest.mark.parametrize("arch", ["llama3.2-1b", "glm4-9b", "zamba2-2.7b",
                                  "xlstm-1.3b", "whisper-small"])
def test_decode_state_specs_divisible(arch):
    cfg = treg.get_config(arch)
    mesh = make_production_mesh()
    shapes = TM.decode_state_specs(cfg, SHAPES["decode_32k"])
    specs = SH.decode_state_pspecs(cfg, shapes, mesh)
    bad = [(keys, tuple(leaf.shape), spec) for (keys, leaf), spec in zip(
        SH.leaves_with_keys(shapes), SH.spec_leaves(specs))
        if not _divides(leaf, spec, mesh)]
    assert not bad, bad


def test_named_pairs_specs_with_their_mesh():
    cfg = treg.get_config("llama3.2-1b")
    mesh = make_production_mesh()
    specs = SH.param_pspecs(cfg, TM.param_specs(cfg), mesh)
    named = SH.named(mesh, specs)
    assert named["embed"] == SH.NamedSharding(mesh, specs["embed"])
    assert named["blocks"][0]["attn"]["wq"].spec == (None, None, "model")
