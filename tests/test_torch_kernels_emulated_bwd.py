"""The bf16 routes of the mamba_scan and mlstm backward kernels (the
chunk-parallel scan on the tensor cores, and mlstm's tensor-core
products) on the CPU emulation of the CUDA subset
(``tests/cuda_emu/emu.h``), against autograd of their plain versions at
small shapes: whole 64- and 128-wide tiles, a ragged tail, the floor on
most rows, common-part inputs and their rounded-once planted copies,
and reruns bit-equal.  The translation, the build and the checks are
``test_torch_kernels_emulated``'s (whose cases cover both routes at
other shapes); this file builds only the two backward sources, so that
the test workers run it beside that one.  Needs g++ with C++20; the
tests skip without it.
"""
import shutil

import pytest
import torch

import test_torch_kernels_emulated as E
from repro_torch.kernels.mamba_scan import ops as SO
from repro_torch.kernels.mamba_scan import ref as SR
from repro_torch.kernels.mlstm import ops as MO
from repro_torch.kernels.mlstm import ref as MR

torch.set_num_threads(2)   # several test workers share the cores


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to build the emulated kernels")
    out = tmp_path_factory.mktemp("emu_bwd")
    return {"scan_bwd": E.build(SO._BWD_SOURCE.read_text(), SO._SOURCE.parent,
                                out, "scan_bwd", SO._BWD_SIG),
            "mlstm_bwd": E.build(MO._BWD_SOURCE.read_text(),
                                 MO._SOURCE.parent, out, "mlstm_bwd",
                                 MO._BWD_SIG),
            "out": out}


def _bit_equal(one, two):
    return all(torch.equal(u, w) for u, w in zip(one, two))


# (B, L, H, P, N, chunk, gates, dtype, d s_fin): whole 64 x 64 tiles over
# two chunks, and one chunk only (no state enters or leaves it but
# ds_fin's)
SCAN_TC_CASES = [(1, 128, 2, 64, 64, 64, "slow", torch.bfloat16, False),
                 (1, 64, 2, 64, 64, 64, "jax", torch.bfloat16, True)]
# the common-part case (ref.scan_inputs(inputs="common")): the state
# entering each chunk has a large common part that dY S_in cancels
SCAN_BWD_COMMON = (1, 192, 2, 64, 64, 64, "slow", torch.bfloat16, False)


@pytest.mark.parametrize("case", SCAN_TC_CASES)
def test_emulated_mamba_scan_bwd_tensor_core_route(libs, case):
    ok, share, got = E._scan_bwd_ok(libs["scan_bwd"], case)
    assert all(ok.values()), ok
    if case[6] == "slow":
        assert share > 0.1, share
    _, _, again = E._scan_bwd_ok(libs["scan_bwd"], case)
    assert _bit_equal(got, again)


def test_emulated_mamba_scan_bwd_keeps_state_precision(libs):
    """bf16, states with a large common part: dY S_in from S_in's three
    bf16 parts passes."""
    ok, share, _ = E._scan_bwd_ok(libs["scan_bwd"], SCAN_BWD_COMMON,
                                  "common")
    assert all(ok.values()), ok
    assert share > 0.1, share


def test_emulated_mamba_scan_bwd_checks_catch_state_rounded_once(libs):
    """mamba_scan_bwd.cu with only S_in's first part in dY S_in
    (ref.BWD_ROUND_FAULT) fails the common-part case, in dc."""
    lib = E._scan_bwd_fault_lib(libs, SR.BWD_ROUND_FAULT, "scan_bwd_round")
    ok, _, _ = E._scan_bwd_ok(lib, SCAN_BWD_COMMON, "common")
    assert not ok["dc"], ok


# (B, L, H, hd, chunk, gates, inputs, dtype): the products over whole
# 128-wide tiles, a ragged 250 (the last chunk's 58 rows), the floor on
# most rows
MLSTM_TC_CASES = [(1, 256, 1, 128, 64, "slow", "random", torch.bfloat16),
                  (1, 250, 1, 128, 64, "slow", "random", torch.bfloat16),
                  (1, 128, 1, 128, 64, "slow", "floor", torch.bfloat16)]
# the common-part case (ref.grad_inputs(inputs="common")): the states C
# have a large common part that U = dH C cancels
MLSTM_BWD_COMMON = (1, 256, 1, 128, 64, "slow", "common", torch.bfloat16)


@pytest.mark.parametrize("case", MLSTM_TC_CASES)
def test_emulated_mlstm_bwd_tensor_core_route(libs, case):
    ok, share, got = E._mlstm_bwd_ok(libs["mlstm_bwd"], case)
    assert all(ok.values()), ok
    if case[6] == "floor":
        assert share > 0.5, share
    if case[1] == 256:
        _, _, again = E._mlstm_bwd_ok(libs["mlstm_bwd"], case)
        assert _bit_equal(got, again)


def test_emulated_mlstm_bwd_keeps_state_precision(libs):
    """bf16, states C with a large common part: U = dH C from C's hi + lo
    bf16 pair passes."""
    ok, _, _ = E._mlstm_bwd_ok(libs["mlstm_bwd"], MLSTM_BWD_COMMON)
    assert all(ok.values()), ok


def test_emulated_mlstm_bwd_checks_catch_state_rounded_once(libs):
    """mlstm_bwd.cu whose U = dH C takes only C's first bf16 part
    (ref.BWD_ROUND_FAULT) fails the common-part case."""
    lib = E._mlstm_bwd_fault_lib(libs, MR.BWD_ROUND_FAULT, "mlstm_bwd_round")
    ok, _, _ = E._mlstm_bwd_ok(lib, MLSTM_BWD_COMMON)
    assert not all(ok.values()), ok
