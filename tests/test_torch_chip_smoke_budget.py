"""What chip_smoke.py checks on the card, pinned, so that the script's time
budget is met by making its checks cheaper and never by dropping one: the
``dryrun`` cells and their planted analyses, the slstm rows, every
kernel's planted faults, and the serving and training families at their
depths.  And the helpers that make the checks cheaper: the fake-CUDA
comparison's depth (whole periods of the layer pattern, every block kind
of the cell), the graphed sLSTM token loop, bit-equal to the eager one
(on the CPU its blocks run eagerly; the card compares the graph replay),
and the profile windows' host table read from raw events, equal to
``key_averages()``'s.
"""
import inspect
import os
import re
import sys

import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.kernels.mamba_scan import ref as MR
from repro_torch.kernels.mlstm import ref as LR
from repro_torch.kernels.moe_gmm import ref as GR
from repro_torch.kernels.slstm import ref as SR
from repro_torch.launch import hloanalysis

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

SOURCE = inspect.getsource(chip_smoke)

DRYRUN_CELLS = [
    "train_4k-llama1b", "train_4k-llama3b", "train_4k-granite",
    "train_4k-xlstm", "prefill_32k-llama1b", "prefill_32k-glm9b",
    "prefill_32k-zamba2", "prefill_32k-xlstm", "decode_32k-llama1b",
    "decode_32k-minitron4b", "decode_32k-xlstm", "long_500k-zamba2",
    "long_500k-xlstm", "flash"]
# every planted copy of a kernel source that build_all builds, and the
# check that loads it (an f-string where one check loads several)
FAULT_BUILDS = {
    "moe_gmm_bwd_fault": '"moe_gmm_bwd_fault"',
    "mamba_scan_carry_fault": '"mamba_scan_carry_fault"',
    "flash_attention_rescale_fault": '"flash_attention_rescale_fault"',
    "mamba_scan_bwd_fault": '"mamba_scan_bwd_fault"',
    "mamba_scan_bwd_round_fault": '"mamba_scan_bwd_round_fault"',
    "mlstm_parts_fault": '"mlstm_parts_fault"',
    "mlstm_bwd_carry_fault": 'f"mlstm_bwd_{fault}_fault"',
    "mlstm_bwd_floor_fault": 'f"mlstm_bwd_{fault}_fault"',
    "mlstm_bwd_round_fault": 'f"mlstm_bwd_{fault}_fault"',
    "slstm_layout_fault": 'f"slstm_{fault}_fault"',
    "slstm_rescale_fault": 'f"slstm_{fault}_fault"',
    "slstm_exchange_fault": 'f"slstm_{fault}_fault"',
    "slstm_bwd_carry_fault": '"slstm_bwd_carry_fault"'}
# (arch, tag, layers) as the script serves and trains them
FAMILIES = [("granite-moe-1b-a400m", "moe", None),
            ("phi3.5-moe-42b-a6.6b", "moe_phi", 8),
            ("zamba2-2.7b", "hybrid", None), ("xlstm-1.3b", "ssm", 8),
            ("whisper-small", "audio", None),
            ("llama-3.2-vision-11b", "vlm", None)]
TRAIN_FAMILIES = [("whisper-small", "audio", None),
                  ("granite-moe-1b-a400m", "moe", None),
                  ("llama-3.2-vision-11b", "vlm", 10),
                  ("zamba2-2.7b", "hybrid", 12), ("xlstm-1.3b", "ssm", 16)]


def test_dryrun_cells_are_pinned():
    assert [c[0] for c in chip_smoke.DRYRUN_CELLS] == DRYRUN_CELLS


@pytest.mark.parametrize("gate", [
    'fault_no_remat"]["launches_ok"]', 'fault_no_lse"]["mem_ok"]',
    'fault_whole_nbytes"]["fake_cuda_equal"]'])
def test_dryrun_phase_asserts_each_planted_analysis_fails(gate):
    src = inspect.getsource(chip_smoke.dryrun_phase)
    assert re.search(r"assert not \w+\[\"" + re.escape(gate), src)


def test_dryrun_phase_holds_every_gate():
    src = inspect.getsource(chip_smoke.dryrun_phase)
    for gate in ("launches_ok", "mem_ok", "bound_ok", "finite",
                 "fake_cuda_equal"):
        assert f'r["{gate}"]' in src, gate


def test_slstm_rows_are_pinned():
    assert chip_smoke.SLSTM_ROWS == [
        (2, 512, "model", False), (1, 4096, "slow", False),
        (1, 32768, "slow", False), (100, 1, "model", True),
        (1, 1000, "model", True)]
    assert chip_smoke.SLSTM_BWD_ROWS == [
        (2, 512, "model", False, False), (1, 4096, "slow", False, False),
        (2, 300, "slow", True, True)]
    assert tuple(chip_smoke.SLSTM_EAGER_ROW) in {
        r[:2] for r in chip_smoke.SLSTM_ROWS}


@pytest.mark.parametrize("name", sorted(FAULT_BUILDS))
def test_each_planted_fault_is_built_and_loaded(name):
    build = inspect.getsource(chip_smoke.build_all)
    assert f'"{name}":' in build
    assert re.search(r"_build\.load\(\s*" + re.escape(FAULT_BUILDS[name]),
                     SOURCE)


@pytest.mark.parametrize("ref, names", [
    (FR, ["FWD_RESCALE_FAULT"]), (MR, ["FWD_CARRY_FAULT", "BWD_CARRY_FAULT",
                                       "BWD_ROUND_FAULT"]),
    (LR, ["FWD_PARTS_FAULT", "BWD_CARRY_FAULT", "BWD_FLOOR_FAULT",
          "BWD_ROUND_FAULT"]),
    (GR, ["BWD_ROUND_FAULT"]), (SR, ["BWD_CARRY_FAULT"])])
def test_fault_texts_are_swaps(ref, names):
    for n in names:
        old, new = getattr(ref, n)
        assert old != new and old, n
    if ref is SR:
        assert sorted(SR.FWD_FAULTS) == ["exchange", "layout", "rescale"]


def test_families_keep_their_depths():
    got = [(a, t, n) for a, t, n, _ in chip_smoke.FAMILIES]
    assert got == FAMILIES
    got = [tuple(f[:3]) for f in chip_smoke.TRAIN_FAMILIES]
    assert got == TRAIN_FAMILIES


def test_budget_marks():
    assert chip_smoke.BUDGET_PHASES_S == 1000
    assert chip_smoke.BUDGET_COMMAND_S == 1200


@pytest.mark.parametrize("cell", [c for c in chip_smoke.DRYRUN_CELLS
                                  if c[2] != "flash"],
                         ids=lambda c: c[0])
def test_fake_depth_is_whole_periods_with_every_block_kind(cell):
    cfg = get_config(cell[1])
    k = chip_smoke.fake_depth(cfg)
    period = len(cfg.period())
    assert k % period == 0 and chip_smoke.FAKE_MIN_LAYERS <= k
    assert k < period + chip_smoke.FAKE_MIN_LAYERS   # the fewest
    assert k <= cfg.n_layers
    cut = cfg.with_(n_layers=k)
    assert cut.period() == cfg.period()
    assert set(cut.block_kinds()) == set(cfg.block_kinds())


def test_planted_whole_nbytes_counts_a_broadcast_whole():
    base = torch.empty((4, 1, 16), device="meta")
    wide = base.expand(4, 8, 16)
    assert hloanalysis._nbytes(wide) == 4 * 16 * 4
    assert chip_smoke._planted_whole_nbytes(wide) == 4 * 8 * 16 * 4
    dense = torch.empty((4, 8, 16), device="meta")
    assert chip_smoke._planted_whole_nbytes(dense) == \
        hloanalysis._nbytes(dense)


@pytest.mark.parametrize("b, length, state", [
    (2, 130, True), (1, 64, False), (3, 5, True), (1, 128, True)])
def test_graphed_loop_is_bit_equal_to_the_token_loop(b, length, state):
    gx, r, bf, st = SR.slstm_inputs(b, length, 32, 4, seed=length + b,
                                    gates="slow", state=state,
                                    rdtype=torch.bfloat16)
    y, fin = SR.slstm_scan(gx, r, bf, st, 4)
    yg, fg = SR.slstm_scan_graphed(gx, r.float(), bf, st, 4)
    assert torch.equal(y, yg)
    for k in SR.STATE_KEYS:
        assert torch.equal(fin[k], fg[k]), k


def test_graphed_loop_in_f64_is_the_f64_token_loop():
    gx, r, bf, st = SR.slstm_inputs(2, 70, 32, 4, seed=7, state=True)
    r64, bf64 = r.double(), bf.double()
    s = {k: v.double() for k, v in st.items()}
    hs = []
    for t in range(gx.shape[1]):
        s = SR.slstm_cell(gx[:, t].double(), s, r64, bf64, 4)
        hs.append(s["h"])
    got = chip_smoke._slstm_f64(torch, SR, gx, r, bf, st, 4)
    assert got.dtype == torch.float64
    assert torch.equal(got, torch.stack(hs, dim=1))


def test_parts_add_up_by_name():
    chip_smoke._PARTS.clear()
    chip_smoke.add_part("x", 1.0)
    chip_smoke.add_part("x", 0.5)
    chip_smoke.lap("z")
    chip_smoke.lap("z")
    assert chip_smoke._PARTS["x"] == 1.5
    assert list(chip_smoke._PARTS) == ["x", "z"]
    chip_smoke._PARTS.clear()


def _profiled_window():
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.GELU(),
                              torch.nn.LayerNorm(32), torch.nn.Linear(32, 4))
    x = torch.randn(8, 16)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            net(x).softmax(-1).sum().backward()   # autograd's own thread
            with torch.no_grad():
                torch.cat([x, x]).matmul(torch.randn(16, 4))
    return prof


def test_host_self_ops_equal_key_averages():
    prof = _profiled_window()
    got = chip_smoke.host_self_ops(prof)
    want = [(e.key, e.self_cpu_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    assert len(got) > 10 and got == want


def test_device_events_of_a_host_window_are_none():
    assert chip_smoke.device_events(_profiled_window()) == []
