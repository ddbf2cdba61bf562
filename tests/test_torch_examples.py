"""The port's example twins (``examples/*_torch.py``) on the CPU: each
``main(["--device", "cpu"])`` runs with its own assertions, and the
control-plane outcomes it returns equal those the JAX example prints on
the same seeds (each test starts its JAX example in an 8-device
subprocess, from a copy whose fixed /tmp path lies in the test's own
directory, and runs the twin meanwhile, as
``tests/test_torch_collectives.py`` spawns its JAX runs).  Losses and
token ids are not compared: the packages' weight initialisations differ.
``quickstart_torch.py`` (4 ranks in 2 pods, compressed sync) has no JAX
counterpart of the same content; its own assertion and its mesh are
checked.  Without ``--device cpu`` every twin asks for CUDA.
"""
import ast
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
JAX_EXAMPLES = ("spot_fleet", "multi_tenant_fabric", "fault_tolerant_elastic",
                "serve_longcontext_ssm")
TWINS = [f"{n}_torch" for n in JAX_EXAMPLES] + ["quickstart_torch"]

torch.set_num_threads(2)   # several test workers share the cores


def _twin(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _start_jax(name, tmp_path, procs):
    """Start the JAX example ``name`` in an 8-device subprocess, from a copy
    in ``tmp_path`` whose fixed path under /tmp (fault_tolerant_elastic's
    checkpoint directory) lies in ``tmp_path`` instead; append it to
    ``procs``.  Returns a function that waits for it and returns what it
    printed."""
    tmp_path.mkdir(exist_ok=True)
    text = (EXAMPLES / f"{name}.py").read_text()
    script = tmp_path / f"{name}.py"
    assert text.count("/tmp/") == text.count("/tmp/repro-fte"), name
    script.write_text(text.replace("/tmp/repro-fte", str(tmp_path / "fte")))
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    log_path = tmp_path / f"{name}.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, str(script)], env=env,
                                cwd=tmp_path, stdout=log,
                                stderr=subprocess.STDOUT, text=True)
    procs.append(proc)

    def wait():
        rc = proc.wait(timeout=600)
        out = log_path.read_text()
        assert rc == 0, out[-3000:]
        return out
    return wait


@pytest.fixture
def jax_output(tmp_path):
    """``start(name)`` starts the test's JAX example, which runs while the
    test runs its twin, and returns the function that waits for its
    output.  A subprocess still running when the test ends is killed."""
    procs = []
    yield lambda name: _start_jax(name, tmp_path / "jax", procs)
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _after(text, prefix):
    """The rest of the first line of ``text`` that starts with ``prefix``."""
    line = next(ln for ln in text.splitlines() if ln.startswith(prefix))
    return line[len(prefix):]


def test_spot_fleet_twin_matches_jax(jax_output):
    jax = jax_output("spot_fleet")
    out = _twin("spot_fleet_torch").main(["--device", "cpu"])
    text = jax()
    churn = ast.literal_eval(_after(text, "churn events: "))
    m1 = re.search(r"completion order (\[.*?\]) makespan ([\d.]+) s",
                   _after(text, "spot wave survived: "))
    m2 = re.search(r"completion order (\[.*?\]) makespan ([\d.]+) s",
                   _after(text, "risk-aware wave survived: "))
    m3 = re.search(r"shrank (\d+)x and regrew (\d+)x .*train-0 lost "
                   r"([\d.]+)s", _after(text, "train-wide "))
    assert out["churn"] == churn
    assert out["order"] == ast.literal_eval(m1.group(1))
    assert round(out["makespan"], 1) == float(m1.group(2))
    assert out["order2"] == ast.literal_eval(m2.group(1))
    assert round(out["makespan2"], 1) == float(m2.group(2))
    assert (out["shrinks"], out["regrows"]) == (int(m3.group(1)),
                                                int(m3.group(2)))
    assert round(out["lost_work_s"], 1) == float(m3.group(3))
    assert out["recoveries2"] == 0 and out["lost_work_s2"] == 0.0
    served = re.search(r"(\d+) requests x (\d+) tokens",
                       _after(text, "serve-0 drained gracefully: "))
    assert [len(out["serve_outputs"]), len(out["serve_outputs"][0])] == \
        [int(served.group(1)), int(served.group(2))]


def test_multi_tenant_fabric_twin_matches_jax(jax_output):
    jax = jax_output("multi_tenant_fabric")
    out = _twin("multi_tenant_fabric_torch").main(["--device", "cpu"])
    text = jax()
    m = re.match(r"(\d+) chips on (\d+) hosts", _after(text, "fabric: "))
    assert (out["chips"], out["hosts"]) == (int(m.group(1)), int(m.group(2)))
    assert out["evict"] == ast.literal_eval(
        _after(text, "high-priority arrival (6 chips): evict "))
    ck = re.search(r"checkpointed train0 at step (\d+)", text)
    assert out["checkpoint_step"] == int(ck.group(1))
    resumed = re.search(r"train0 resumed at step (\d+)", text)
    assert out["resume_step"] == int(resumed.group(1))
    assert len(out["losses"]) == len(out["ref_losses"]) == 6
    assert [len(o) for o in out["serve_outputs"]] == [4, 4]


def test_fault_tolerant_elastic_twin_matches_jax(jax_output, tmp_path):
    jax = jax_output("fault_tolerant_elastic")
    out = _twin("fault_tolerant_elastic_torch").main(
        ["--device", "cpu", "--ckpt-dir", str(tmp_path / "torch")])
    text = jax()
    assert out["devices"] == int(_after(text, "devices: "))
    m = re.search(r"recoveries=(\d+) rescales=(\d+)", text)
    assert (out["recoveries"], out["rescales"]) == (int(m.group(1)),
                                                    int(m.group(2)))
    # every step before the rescale at step 16 (the replayed ones too) on
    # 8 ranks, the 8 after it on 4
    assert set(out["worlds"][:-8]) == {8} and out["worlds"][-8:] == [4] * 8


def test_serve_longcontext_ssm_twin_matches_jax(jax_output):
    jax = jax_output("serve_longcontext_ssm")
    out = _twin("serve_longcontext_ssm_torch").main(["--device", "cpu"])
    text = jax()
    mib = float(re.match(r"([\d.]+) MiB", _after(text, "recurrent state: "))
                .group(1))
    gen = re.search(r"generated (\d+) tokens; post-migration continuation "
                    r"bit-exact: (\w+)", text)
    assert round(out["state_mib"], 1) == mib
    assert out["generated"] == int(gen.group(1))
    assert out["bit_exact"] and gen.group(2) == "True"


def test_quickstart_twin_runs(tmp_path):
    out = _twin("quickstart_torch").main(["--device", "cpu", "--ckpt-dir",
                                          str(tmp_path)])
    assert out["ranks"] == 4 and out["mesh"] == {"pod": 2, "data": 2}
    assert len(out["losses"]) == 30 and out["losses"][-1] < out["losses"][0]
    assert len(out["generated"]) == 8


@pytest.mark.parametrize("name", TWINS)
def test_twins_ask_for_cuda_by_default(name):
    """Without ``--device`` a twin runs on CUDA, and raises where there is
    none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        _twin(name).main([])
