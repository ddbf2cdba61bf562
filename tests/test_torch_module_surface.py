"""Every module of the JAX package (``src/repro/``) against its port
(``src/repro_torch/``): each public top-level name a JAX module defines
must be an attribute of the port's module of the same path, unless the
allow-list below names it with the reason it is JAX-only.  A module with
no counterpart must be allow-listed whole.  The JAX modules are read with
``ast`` (not imported); the port's are imported.
"""
import ast
import importlib
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
JAX_ROOT, PORT_ROOT = SRC / "repro", SRC / "repro_torch"

_PALLAS = ("the Pallas kernel for the TPU; the CUDA sources under "
           "csrc/ replace it")
# module path -> reason: JAX modules with no port counterpart
JAX_ONLY_MODULES = {
    "core/compat.py": "shims over JAX API versions (shard_map, mesh axis "
                      "types, Pallas compiler params); the port has no JAX",
    "kernels/collective_codec/kernel.py": _PALLAS,
    "kernels/diff_merge/kernel.py": _PALLAS,
    "kernels/flash_attention/kernel.py": _PALLAS,
    "kernels/mamba_scan/kernel.py": _PALLAS,
    "kernels/mlstm/kernel.py": _PALLAS,
    "kernels/moe_gmm/kernel.py": _PALLAS,
}
_SHARD_MAP = ("a named-axis collective run inside shard_map; the port runs "
              "the same schedules over its virtual ranks in tree_sync")
_HLO = "parses compiled HLO text; the port has no XLA compiler"
# (module path, name) -> reason: names the port leaves out
JAX_ONLY_NAMES = {
    ("core/collectives.py", "HLO_COLLECTIVE_KINDS"): _HLO,
    ("core/collectives.py", "collective_bytes_from_hlo"): _HLO,
    ("core/collectives.py", "slowlink_bytes_from_hlo"): _HLO,
    ("core/collectives.py", "hierarchical_psum"): _SHARD_MAP,
    ("core/collectives.py", "flat_psum"): _SHARD_MAP,
    ("core/collectives.py", "ring_allreduce"): _SHARD_MAP,
    ("core/collectives.py", "compressed_hierarchical_psum"): _SHARD_MAP,
    ("core/collectives.py", "build_tree_allreduce"):
        "builds a shard_map'd all-reduce over a jax Mesh; the port's is "
        "tree_sync over virtual ranks",
    ("core/collectives.py", "tree_sync_body"): _SHARD_MAP,
    ("core/collectives.py", "dp_axes"):
        "names a jax Mesh's axes; a port GangMesh has pods and data",
    ("core/collectives.py", "mesh_pod_of"):
        "maps jax Device ids to pods; a port GangMesh has pods and data",
    ("core/elastic.py", "batch_shardings"):
        "a NamedSharding per batch leaf; the port's ranks take batch slices "
        "(data.pipeline.shard_slice) on one device",
    ("kernels/collective_codec/ops.py", "KERNEL_MIN_SIZE"):
        "the size above which a TPU takes the pallas_call; the port routes "
        "by device (CUDA kernel, or the plain version on the CPU)",
    ("kernels/mamba_scan/ref.py", "ssd_ref"):
        "a per-token lax.scan oracle of the JAX tests; the port's tests "
        "reach it through the JAX package",
    ("kernels/mlstm/ref.py", "mlstm_ref"):
        "a per-token lax.scan oracle of the JAX tests; the port's tests "
        "reach it through the JAX package",
    ("launch/dryrun.py", "ICI_BW"):
        "the TPU's inter-chip link rate; the port's dry-run models NVLink",
    ("launch/hloanalysis.py", "DTYPE_BYTES"): _HLO,
    ("launch/hloanalysis.py", "analyze"):
        "the HLO text parser; the port's op-trace analysis is "
        "Recorder.analyze",
    ("models/attention.py", "sdpa_blocked_scan"):
        "the lax.scan twin of the blocked attention; the port runs its "
        "loops eagerly, one function",
    ("models/layers.py", "fused_unembed_xent_scan"):
        "the lax.scan twin of fused_unembed_xent; the port runs its loops "
        "eagerly, one function",
}


def _public_names(path: Path):
    """The public names a module binds at its top level: functions,
    classes and assigned names."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                out.update(n.id for n in ast.walk(t)
                           if isinstance(n, ast.Name))
    return {n for n in out if not n.startswith("_")}


JAX_MODULES = sorted(p.relative_to(JAX_ROOT).as_posix()
                     for p in JAX_ROOT.rglob("*.py"))


def _port_module(rel: str):
    parts = Path(rel).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return importlib.import_module(".".join(("repro_torch",) + parts))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_defines_the_jax_modules_names(rel):
    if rel in JAX_ONLY_MODULES:
        assert not (PORT_ROOT / rel).exists(), \
            f"{rel} is ported now: take it off JAX_ONLY_MODULES"
        return
    assert (PORT_ROOT / rel).exists(), f"no port of {rel}"
    mod = _port_module(rel)
    missing = sorted(n for n in _public_names(JAX_ROOT / rel)
                     if not hasattr(mod, n)
                     and (rel, n) not in JAX_ONLY_NAMES)
    assert not missing, f"{rel}: the port lacks {missing}"


def test_allow_list_is_current():
    """Each allowed name is still defined by its JAX module, still
    missing from the port, and has a reason."""
    for (rel, name), reason in JAX_ONLY_NAMES.items():
        assert reason and name in _public_names(JAX_ROOT / rel), (rel, name)
        assert not hasattr(_port_module(rel), name), \
            f"{rel}:{name} is ported now: take it off JAX_ONLY_NAMES"
    assert all(JAX_ONLY_MODULES.values())

