"""The port's dry-run (``launch.dryrun``): the matmul FLOPs of reduced
train and prefill steps on the meta device (the plain route) against the
dots of the JAX package's own steps; the difference method against a
direct trace; the kernels' calls per step; the roofline on hand values;
the analysis route taken for tensors that hold no data and stand for the
card's, and only for them; and the CLI and report on a machine with no
GPU."""
import json
import math
import os
import re
import subprocess
import sys

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import registry as jreg
from repro.configs.base import ShapeConfig as JShape
from repro.models import model as JM
from repro.optim.adamw import AdamWConfig as JAdamW
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import analysis
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.mamba_scan import ops as ms
from repro_torch.kernels.mlstm import ops as ml
from repro_torch.kernels.moe_gmm import ops as gmm
from repro_torch.launch import dryrun as dr
from repro_torch.launch.hloanalysis import Recorder
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as TM
from repro_torch.optim.adamw import AdamWConfig

torch.set_num_threads(2)   # several test workers share the cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE = make_host_mesh((1, 1), ("data", "model"))
B, S = 2, 64

# ---------------------------------------------------------------------------
# matmul FLOPs against the JAX step's dots
# ---------------------------------------------------------------------------
_DEF = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*\w+\[([\d,]*)\]")
_DOT = re.compile(r"=\s*\w+\[([\d,]*)\][^=]*?\sdot\(%?([\w.\-]+),"
                  r".*lhs_contracting_dims=\{([\d,]*)\}")


def dot_flops(hlo: str) -> int:
    """2 x (result elements) x (contracted size) over every ``dot`` of an
    HLO module's text, the lhs's shape looked up by name."""
    shapes = {}
    for line in hlo.splitlines():
        m = _DEF.match(line)
        if m:
            shapes[m.group(1)] = [int(d) for d in m.group(2).split(",") if d]
    total = 0
    for line in hlo.splitlines():
        m = _DOT.search(line)
        if m:
            res = [int(d) for d in m.group(1).split(",") if d]
            lhs = shapes[m.group(2)]
            k = math.prod(lhs[int(c)] for c in m.group(3).split(",") if c)
            total += 2 * math.prod(res) * k
    return total


def _jax_step(arch, kind):
    cfg = jreg.reduced_config(arch)
    shape = JShape("x", S, B, kind)
    if kind == "train":
        fn = JM.make_train_step(cfg, JAdamW())
        args = (JM.train_state_specs(cfg, JAdamW()),
                JM.batch_specs(cfg, shape))
    else:
        fn = JM.make_prefill_step(cfg)
        args = (JM.param_specs(cfg),
                JM.batch_specs(cfg, shape, with_labels=False))
    return jax.jit(fn).lower(*args)


def _port_flops(arch, kind):
    cfg = treg.reduced_config(arch)
    fn, args, _ = dr.build_cell(cfg, ShapeConfig("x", S, B, kind), ONE)
    with FlopCounterMode(display=False) as fc, \
            torch.set_grad_enabled(kind == "train"):
        fn(*args)
    return fc.get_total_flops()


@pytest.mark.parametrize("arch,kind", [
    ("llama3.2-1b", "train"), ("llama3.2-1b", "prefill"),
    ("granite-moe-1b-a400m", "train"), ("granite-moe-1b-a400m", "prefill")])
def test_matmul_flops_match_the_jax_steps_dots(arch, kind):
    """Tolerance 1% of the JAX count (observed: equal).  The compiled MoE
    train step has one unembedding-sized product fewer than the program
    JAX lowered (XLA's simplifier folds it), so it is held to that."""
    port = _port_flops(arch, kind)
    lowered = _jax_step(arch, kind)
    assert port == pytest.approx(dot_flops(lowered.as_text(dialect="hlo")),
                                 rel=1e-2)
    compiled = dot_flops(lowered.compile().as_text())
    if (arch, kind) == ("granite-moe-1b-a400m", "train"):
        cfg = jreg.reduced_config(arch)
        assert port - compiled == 2 * B * S * cfg.d_model * cfg.vocab
    else:
        assert port == pytest.approx(compiled, rel=1e-2)


# ---------------------------------------------------------------------------
# the difference method; kernels per step
# ---------------------------------------------------------------------------
def _direct(cfg, kind, b, s):
    fn, args, _ = dr.build_cell(cfg, ShapeConfig("x", s, b, kind), ONE)
    return dr.trace(fn, args, kind == "train")


def _card_cfg(arch, **kw):
    return treg.reduced_config(arch).with_(dtype="bfloat16", **kw)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_difference_method_equals_a_direct_trace(kind):
    cfg = _card_cfg("llama3.2-1b", remat=True, n_layers=4)
    shape = ShapeConfig("x", S, B, kind)
    got = dr.measure(cfg, shape, B)
    want = _direct(cfg, kind, B, S)
    for key in ("flops", "kernel_flops", "argument_bytes"):
        assert got[key] == pytest.approx(want[key], rel=1e-9), key
    assert got["kernels"] == want["kernels"]
    # exact for a training step; a prefill's stacking of the decode
    # states per period position is a few hundred bytes off linear: 0.1%
    assert got["hbm_bytes"] == pytest.approx(
        want["hbm_bytes"], rel=1e-9 if kind == "train" else 1e-3)
    # the peak is where the step's largest live set falls, which is not
    # linear in the depth at this size: 5%
    assert got["peak_bytes"] == pytest.approx(want["peak_bytes"], rel=5e-2)
    assert [p["kernels"]["flash_attention"]["calls"]
            for p in got["probes"]["periods"]] == \
        [(2 if kind == "train" else 1) * k for k in (1, 2)]


def test_sequence_extrapolation_equals_a_direct_trace():
    """The xLSTM family's traces run at SEQ_PROBES and extrapolate over
    the length: exact for FLOPs and kernel calls (every block is linear
    in it); bytes within 1%."""
    cfg = _card_cfg("xlstm-1.3b")
    got = dr.measure(cfg, ShapeConfig("x", 384, 1, "prefill"), 1)
    want = _direct(cfg, "prefill", 1, 384)
    assert got["probes"]["seq"] == list(dr.SEQ_PROBES)
    assert got["flops"] == pytest.approx(want["flops"], rel=1e-9)
    assert {k: v["calls"] for k, v in got["kernels"].items()} == \
        {k: v["calls"] for k, v in want["kernels"].items()}
    assert got["hbm_bytes"] == pytest.approx(want["hbm_bytes"], rel=1e-2)
    assert got["peak_bytes"] == pytest.approx(want["peak_bytes"], rel=1e-2)


def _calls(a):
    return {k: (v["calls"], v["launches"]) for k, v in a["kernels"].items()}


@pytest.mark.parametrize("remat", [True, False])
def test_kernel_calls_per_step(remat):
    """Under remat each forward kernel runs twice a training step (the
    recompute), each backward once; a prefill runs each forward once.
    moe_gmm's bf16 forward is two launches a call, its backward three."""
    f = 2 if remat else 1
    cfg = _card_cfg("llama3.2-1b", remat=remat)
    n = cfg.n_layers
    assert _calls(_direct(cfg, "train", B, S)) == {
        "flash_attention": (f * n, f * n), "flash_attention_bwd": (n, n)}
    assert _calls(_direct(cfg, "prefill", B, S)) == {
        "flash_attention": (n, n)}
    cfg = _card_cfg("granite-moe-1b-a400m", remat=remat)
    n = cfg.n_layers
    assert _calls(_direct(cfg, "train", B, S)) == {
        "flash_attention": (f * n, f * n), "flash_attention_bwd": (n, n),
        "moe_gmm": (f * n, 2 * f * n), "moe_gmm_bwd": (n, 3 * n)}
    cfg = _card_cfg("zamba2-2.7b", remat=remat)
    mamba = sum(k == "mamba" for k in cfg.block_kinds())
    shared = cfg.n_layers - mamba
    assert _calls(_direct(cfg, "train", B, S)) == {
        "mamba_scan": (f * mamba, f * mamba),
        "mamba_scan_bwd": (mamba, mamba),
        "flash_attention": (f * shared, f * shared),
        "flash_attention_bwd": (shared, shared)}


def test_xlstm_and_f32_kernel_calls():
    """xlstm's mLSTM and sLSTM blocks each run their forward kernel twice
    a training step under remat (the recompute) and their backward once;
    a prefill runs each forward once (the sLSTM's one launch a layer, not
    a loop over tokens)."""
    cfg = _card_cfg("xlstm-1.3b", remat=True)
    m = sum(k == "mlstm" for k in cfg.block_kinds())
    s = sum(k == "slstm" for k in cfg.block_kinds())
    assert m > 0 and s > 0
    assert _calls(_direct(cfg, "train", 1, 32)) == {
        "mlstm": (2 * m, 2 * m), "mlstm_bwd": (m, m),
        "slstm": (2 * s, 2 * s), "slstm_bwd": (s, s)}
    assert _calls(_direct(cfg, "prefill", 1, 32)) == {
        "mlstm": (m, m), "slstm": (s, s)}
    cfg = treg.reduced_config("granite-moe-1b-a400m")      # f32
    n = cfg.n_layers
    assert _calls(_direct(cfg, "prefill", B, S)) == {
        "flash_attention": (n, n), "moe_gmm": (n, n)}


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------
def test_roofline_on_hand_values():
    cfg = treg.get_config("llama3.2-1b")
    shape = ShapeConfig("x", 1024, 2, "train")
    n = TM.count_params(cfg, active_only=True)
    rl = dr.roofline({"flops": 989e12}, {"hbm_bytes": 6.7e12,
                                         "collective_bytes": 25e9},
                     cfg, shape, 4)
    assert rl["terms_s"] == pytest.approx(
        {"compute": 1.0, "memory": 2.0, "collective": 0.5})
    assert rl["bottleneck"] == "memory"
    assert rl["step_time_bound_s"] == pytest.approx(2.0)
    assert rl["model_flops"] == 6 * n * 2048
    assert rl["useful_flops_ratio"] == pytest.approx(6 * n * 2048
                                                     / (4 * 989e12))
    assert rl["roofline_fraction"] == pytest.approx(
        6 * n * 2048 / 4 / 989e12 / 2.0)
    rl = dr.roofline({"flops": 0.0}, {}, cfg,
                     ShapeConfig("d", 4096, 8, "decode"), 1)
    assert rl["model_flops"] == 2 * n * 8


# ---------------------------------------------------------------------------
# the analysis route: tensors that hold no data, standing for the card's
# ---------------------------------------------------------------------------
def _qkv(device, dtype=torch.bfloat16, b=1, s=64):
    g = torch.Generator().manual_seed(0)
    return [torch.randn((b, s, h, 64), generator=g).to(dtype).to(device)
            for h in (4, 2, 2)]


def _counts():
    return (fa.launches, fa.bwd_launches, gmm.launches, gmm.bwd_launches,
            ms.launches, ms.bwd_launches, ml.launches, ml.bwd_launches)


def test_fake_cuda_tensors_take_the_analysis_route():
    """Through the wrappers' kernel-layout entries: a CPU-only PyTorch
    cannot copy a fake CUDA tensor (no CUDA device guard), which
    ``flash_attention``'s transposes would; chip_smoke.py's dryrun phase
    traces whole steps on fake CUDA tensors on the card."""
    before = _counts()
    with FakeTensorMode():
        q, k, v = (torch.empty((1, h, 64, 64), dtype=torch.bfloat16,
                               device="cuda") for h in (4, 2, 2))
        assert analysis.traced(q) and q.is_cuda
        out = fa._launch(q, k, v, causal=True, window=0, scale=0.125)
        assert out.shape == q.shape and out.is_cuda
        x = torch.empty((4, 16, 32), dtype=torch.bfloat16, device="cuda")
        w = torch.empty((4, 32, 48), dtype=torch.bfloat16, device="cuda")
        w2 = torch.empty((4, 48, 32), dtype=torch.bfloat16, device="cuda")
        assert gmm.expert_ffn_kernel_layout(x, w, w2, w).shape == x.shape
        xs = torch.empty((1, 64, 2, 16), dtype=torch.bfloat16, device="cuda")
        dt = torch.empty((1, 64, 2), device="cuda")
        bc = torch.empty((1, 64, 8), dtype=torch.bfloat16, device="cuda")
        y, fin = ms.ssd(xs, dt, torch.empty(2, device="cuda"), bc, bc)
        assert y.shape == xs.shape and fin.shape == (1, 2, 16, 8)
        gates = torch.empty((1, 64, 4), device="cuda")
        qm = torch.empty((1, 64, 4, 64), dtype=torch.bfloat16, device="cuda")
        h, (c, _, _) = ml.mlstm(qm, qm, qm, gates, gates)
        assert h.shape == qm.shape and c.shape == (1, 4, 64, 64)
    assert _counts() == before                 # counted, never launched


def test_a_recorder_counts_fake_cuda_kernels():
    with FakeTensorMode():
        q, k, v = (torch.empty((1, h, 64, 64), dtype=torch.bfloat16,
                               device="cuda") for h in (4, 2, 2))
        rec = Recorder()
        with rec:
            fa._launch(q, k, v, causal=True, window=0, scale=0.125)
    assert rec.analyze()["kernels"]["flash_attention"]["flops"] == \
        fa.work(1, 4, 2, 64, 64, True, 0, 2)[0]


def test_meta_and_cpu_tensors_keep_the_plain_route():
    before = _counts()
    q, k, v = (t.to("meta") for t in _qkv("cpu"))
    assert not analysis.traced(q)
    with FlopCounterMode(display=False) as fc:
        out = fa.flash_attention(q, k, v)
    assert out.device.type == "meta" and fc.get_total_flops() > 0
    q, k, v = _qkv("cpu", torch.float32)
    with Recorder() as rec:                    # a CPU tensor holds data
        out = fa.flash_attention(q, k, v)
    assert rec.analyze()["kernels"] == {}
    want = fa_ref.attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                                causal=True, window=0,
                                scale=64 ** -0.5).transpose(1, 2)
    assert torch.equal(out, want)
    assert _counts() == before


# ---------------------------------------------------------------------------
# the CLI and the report, no GPU
# ---------------------------------------------------------------------------
def test_cli_writes_records_and_the_report_reads_them(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    for shape in ("decode_32k", "long_500k"):
        subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "llama3.2-1b", "--shape", shape,
                        "--out-dir", str(tmp_path)], check=True, env=env,
                       stdout=subprocess.DEVNULL, timeout=300)
    rec = json.loads((tmp_path / "llama3.2-1b__decode_32k__16x16.json")
                     .read_text())
    assert rec["applicable"] and rec["fits_hbm_80gb"]
    assert rec["roofline"]["bottleneck"] == "memory"
    skip = json.loads((tmp_path / "llama3.2-1b__long_500k__16x16.json")
                      .read_text())
    assert not skip["applicable"]
    report = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline_report",
         "--results", str(tmp_path)], check=True, env=env,
        capture_output=True, text=True, timeout=120).stdout
    assert "| llama3.2-1b | decode_32k | 16x16 | ok | yes |" in report
    assert "fits 80GB HBM: 1/1" in report
