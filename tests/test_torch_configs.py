"""The port's configs equal the JAX package's field for field; the port
imports neither JAX nor ``repro``; entry points default to CUDA."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg

torch.set_num_threads(2)   # several test workers share the cores

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match_jax(arch, reduced):
    get = "reduced_config" if reduced else "get_config"
    j = getattr(jreg, get)(arch)
    t = getattr(treg, get)(arch)
    jf = dataclasses.asdict(j)
    tf = dataclasses.asdict(t)
    assert jf == tf
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert t.period() == j.period() and t.n_periods() == j.n_periods()
    assert t.hd() == j.hd()
    assert str(t.torch_dtype()).split(".")[-1] == str(j.param_dtype())


def test_shapes_and_cells_match_jax():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for arch in jreg.ARCH_IDS:
        for name in jbase.SHAPES:
            assert tbase.cell_applicable(treg.get_config(arch),
                                         tbase.SHAPES[name]) == \
                jbase.cell_applicable(jreg.get_config(arch),
                                      jbase.SHAPES[name])


def test_port_imports_no_jax_and_no_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        need = {"repro_torch.kernels._build",
                "repro_torch.kernels.collective_codec.ops",
                "repro_torch.kernels.collective_codec.ref",
                "repro_torch.kernels.flash_attention.ops",
                "repro_torch.core.collectives", "repro_torch.data.pipeline",
                "repro_torch.optim.adamw", "repro_torch.optim.compress",
                "repro_torch.runtime.train_loop", "repro_torch.launch.train",
                "repro_torch.models.model", "repro_torch.weights",
                "repro_torch.kernels.diff_merge.ops",
                "repro_torch.kernels.diff_merge.ref",
                "repro_torch.core.snapshot", "repro_torch.core.diffsync",
                "repro_torch.core.migration", "repro_torch.core.control",
                "repro_torch.checkpoint.manager",
                "repro_torch.kernels.moe_gmm.ops",
                "repro_torch.kernels.moe_gmm.ref",
                "repro_torch.kernels.mamba_scan.ops",
                "repro_torch.kernels.mamba_scan.ref",
                "repro_torch.models.moe", "repro_torch.models.ssm",
                "repro_torch.kernels.mlstm", "repro_torch.kernels.mlstm.ops",
                "repro_torch.kernels.mlstm.ref", "repro_torch.models.xlstm"}
        assert need <= set(names), sorted(need - set(names))
        assert len(names) >= 60, names
        print("imported", len(names))
    """)
    env = {**os.environ, "PYTHONPATH": SRC}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_chip_smoke_imports_no_jax_and_no_repro():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    with open(path) as f:
        src = f.read()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            mod = s.split()[1]
            assert not mod.startswith(("jax", "repro.")) and mod != "repro", s


def test_entry_points_default_to_cuda():
    from repro_torch import resolve_device
    from repro_torch.models import transformer as tf
    from repro_torch.weights import params_from_numpy
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    cfg = treg.reduced_config("llama3.2-1b")
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.init_decode_state(cfg, 1, 8, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"embed": torch.zeros(2).numpy()})
    assert resolve_device("cpu").type == "cpu"
