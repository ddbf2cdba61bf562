"""The port's shape specs (``models.model``: meta tensors) against the JAX
package's ``jax.ShapeDtypeStruct`` specs, leaf by leaf (path, shape,
dtype), for all ten architectures at full size; ``decode_window``; and
``build(cfg)``'s steps equal to the direct ones on a reduced config."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import SHAPES as JSHAPES
from repro.models import model as JM
from repro.optim.adamw import AdamWConfig as JAdamW
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES
from repro_torch.models import model as TM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.weights import tree_leaves, tree_leaves_with_path

torch.set_num_threads(2)   # several test workers share the cores

ARCHS = list(treg.ARCH_IDS)


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _same(port_tree, jax_tree, skip=()):
    """Every leaf of both trees: equal paths, shapes and dtypes (paths in
    ``skip`` are compared by the caller)."""
    jl = [(jax.tree_util.keystr(p), tuple(x.shape), np.dtype(x.dtype).name)
          for p, x in jax.tree_util.tree_flatten_with_path(jax_tree)[0]]
    tl = [(p, tuple(x.shape), _dtype(x))
          for p, x in tree_leaves_with_path(port_tree)
          if isinstance(x, torch.Tensor)]
    assert [x for x in jl if x[0] not in skip] == tl
    assert all(x.device.type == "meta" for x in tree_leaves(port_tree)
               if isinstance(x, torch.Tensor))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_train_state_specs(arch):
    tcfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    _same(TM.param_specs(tcfg), JM.param_specs(jcfg))
    tstate = TM.train_state_specs(tcfg, AdamWConfig())
    jstate = JM.train_state_specs(jcfg, JAdamW())
    _same(tstate, jstate, skip=("['opt']['step']",))
    # the port's step is a host int, the JAX package's a () int32 array
    assert tstate["opt"]["step"] == 0
    assert jstate["opt"]["step"].shape == ()
    assert np.dtype(jstate["opt"]["step"].dtype) == np.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_decode_specs_and_window(arch):
    tcfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    for name in ("train_4k", "prefill_32k"):
        for labels in (True, False):
            _same(TM.batch_specs(tcfg, SHAPES[name], with_labels=labels),
                  JM.batch_specs(jcfg, JSHAPES[name], with_labels=labels))
    names = ["decode_32k"] + (["long_500k"] if tcfg.is_subquadratic()
                              else [])
    for name in names:
        _same(TM.decode_state_specs(tcfg, SHAPES[name]),
              JM.decode_state_specs(jcfg, JSHAPES[name]))
        _same(TM.decode_input_specs(tcfg, SHAPES[name]),
              JM.decode_input_specs(jcfg, JSHAPES[name]))
    for name in SHAPES:
        assert TM.decode_window(tcfg, SHAPES[name]) == \
            JM.decode_window(jcfg, JSHAPES[name])


def _init_state(cfg, ocfg):
    gen = torch.Generator().manual_seed(0)
    return TM.init_train_state(gen, cfg, ocfg, device="cpu")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m"])
def test_build_matches_the_direct_functions(arch):
    cfg = treg.reduced_config(arch)
    ocfg = AdamWConfig(warmup_steps=1, total_steps=4)
    api = TM.build(cfg)
    assert api.cfg is cfg
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    a, b = _init_state(cfg, ocfg), _init_state(cfg, ocfg)
    a, ma = api.make_train_step(ocfg)(a, batch)
    b, mb = TM.make_train_step(cfg, ocfg)(b, batch)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a["params"]),
                                                 tree_leaves(b["params"])))
    assert all(torch.equal(ma[k], mb[k]) for k in mb)
    params = api.init_params(torch.Generator().manual_seed(2), device="cpu")
    ref = TM.make_prefill_step(cfg)(params, {"tokens": toks})[0]
    with torch.no_grad():
        got = api.make_prefill_step()(params, {"tokens": toks})[0]
    assert torch.equal(got, ref)
    loss, _ = api.loss_fn(params, batch)
    assert torch.isfinite(loss)


def test_train_step_holds_pspecs_against_ranks():
    """``grad_pspecs`` / ``batch_pspecs`` move no data on one card; a spec
    of the wrong rank raises."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import shardings as sh
    cfg = treg.reduced_config("llama3.2-1b")
    ocfg = AdamWConfig()
    mesh = make_host_mesh((1, 1), ("data", "model"))
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(3))
    batch = {"tokens": toks, "labels": toks}
    gspecs = sh.param_pspecs(cfg, TM.param_specs(cfg), mesh)
    bspecs = sh.batch_pspecs(cfg, batch, mesh)
    a, b = _init_state(cfg, ocfg), _init_state(cfg, ocfg)
    TM.make_train_step(cfg, ocfg, grad_pspecs=gspecs,
                       batch_pspecs=bspecs)(a, batch)
    TM.make_train_step(cfg, ocfg)(b, batch)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a["params"]),
                                                 tree_leaves(b["params"])))
    with pytest.raises(ValueError, match="batch_pspecs"):
        TM.make_train_step(cfg, ocfg, batch_pspecs={
            "tokens": ((),), "labels": ((), None)})(a, batch)
    gspecs["final_norm"] = (None, None)
    with pytest.raises(ValueError, match="grad_pspecs"):
        TM.make_train_step(cfg, ocfg, grad_pspecs=gspecs)(a, batch)
