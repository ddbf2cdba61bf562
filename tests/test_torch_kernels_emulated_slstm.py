"""The slstm kernels (``kernels/slstm/csrc/slstm.cu`` and
``slstm_bwd.cu``) on the CPU emulation of the CUDA subset
(``tests/cuda_emu/emu.h``), against their plain version and its
autograd at xlstm's reduced width (d 64).  Every output starts as NaN
(``ops.call(fill=...)``), so an element the kernel does not write shows.

Both are persistent grids launched cooperatively, with one grid-wide
barrier a step; the emulation runs all blocks of such a launch at once
and, between two barriers, one block at a time in order of their index,
so that a read the barrier does not order sees another block's writes of
the same step.  The translation and the build are
``test_torch_kernels_emulated``'s; this file builds only the slstm
sources, so that the test workers run it beside that one.  The blocks
run with 64 threads (the card's 256 would only slow the emulation) over
3 multiprocessors: 3 blocks of 22, 22 and 20 indices, whose indices span
two heads each.  Tolerances: h, the final state and the histories atol
2e-5 (f32: the recurrent product sums hd terms in another order than the
plain einsum); gradients atol 1e-4 times their largest magnitude (at
least 1) / rtol 1e-4 (the plain version sums them in autograd's order);
dr in r's dtype against the plain autograd's, one bf16 unit for bf16.
Needs g++ with C++20; the tests skip without it.
"""
import ctypes
import shutil

import pytest
import torch

import test_torch_kernels_emulated as E
from repro_torch.kernels.slstm import ops as SO
from repro_torch.kernels.slstm import ref as SR

torch.set_num_threads(2)   # several test workers share the cores

THREADS = 64
KEYS = SR.STATE_KEYS


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to build the emulated kernels")
    out = tmp_path_factory.mktemp("emu_slstm")
    return {"fwd": E.build(SO._SOURCE.read_text(), SO._SOURCE.parent, out,
                           "slstm", SO._SIG),
            "bwd": E.build(SO._BWD_SOURCE.read_text(), SO._SOURCE.parent,
                           out, "slstm_bwd", SO._BWD_SIG),
            "out": out}


def _fault_lib(libs, fault):
    old, new = SR.FWD_FAULTS.get(fault, SR.FWD_BUFFER_FAULT)
    text = SO._SOURCE.read_text()
    assert text.count(old) == 1, "the planted fault's line moved"
    return E.build(text.replace(old, new), SO._SOURCE.parent, libs["out"],
                   f"slstm_{fault}", SO._SIG)


def _forward(lib, case, keep=True):
    b, length, d, h, gates, state, rdtype = case
    ins = SR.slstm_inputs(b, length, d, h, seed=length + 7 * b + h,
                          gates=gates, state=state, rdtype=rdtype)
    err, y, fin, hist = SO.call(lib, *ins, keep, None, threads=THREADS,
                                fill=float("nan"))
    assert err == 0
    return ins, y, fin, hist


def _forward_ok(lib, case):
    """Whether h, each final state leaf and each history pass."""
    ins, y, fin, hist = _forward(lib, case)
    yr, fr, hr = SR.slstm_scan(*ins, case[3], keep=True)
    ok = {"h": torch.allclose(y, yr, atol=2e-5, rtol=0)}
    ok.update({k: torch.allclose(fin[k], fr[k], atol=2e-5, rtol=1e-5)
               for k in KEYS})
    ok.update({f"hist_{k}": torch.allclose(hist[k], hr[k], atol=2e-5,
                                           rtol=1e-5) for k in hr})
    return ok


# (B, L, d, h, gates, state, r dtype): training's shapes scaled down, a
# ragged length from a drawn state with slow forget gates in bf16,
# another head count, decode (L 1) from a state, and 17 rows (two tiles
# of the 16 a step stages)
FWD_CASES = [(2, 16, 64, 4, "model", False, torch.float32),
             (1, 37, 64, 4, "slow", True, torch.bfloat16),
             (3, 9, 64, 2, "slow", True, torch.float32),
             (2, 1, 64, 4, "model", True, torch.bfloat16),
             (17, 3, 64, 4, "model", True, torch.float32)]


@pytest.mark.parametrize("case", FWD_CASES)
def test_emulated_slstm_matches_plain(libs, case):
    ok = _forward_ok(libs["fwd"], case)
    assert all(ok.values()), ok


def test_emulated_slstm_reruns_bit_equal(libs):
    case = FWD_CASES[1]
    _, y1, fin1, hist1 = _forward(libs["fwd"], case)
    _, y2, fin2, hist2 = _forward(libs["fwd"], case)
    assert torch.equal(y1, y2)
    assert all(torch.equal(fin1[k], fin2[k]) for k in KEYS)
    assert all(torch.equal(hist1[k], hist2[k]) for k in hist1)


def test_emulated_slstm_keeps_no_history_unless_asked(libs):
    case = FWD_CASES[0]
    ins, y, fin, hist = _forward(libs["fwd"], case, keep=False)
    assert hist is None
    yr, _ = SR.slstm_scan(*ins, case[3])
    assert torch.allclose(y, yr, atol=2e-5, rtol=0)


@pytest.mark.parametrize("fault", sorted(SR.FWD_FAULTS) + ["buffer"])
def test_emulated_slstm_checks_catch_planted_faults(libs, fault):
    """slstm.cu with the recurrent term laid out gate-major, without the
    carried state's rescale, without the grid barrier between the steps
    (its outputs start as NaN), or reading h of the step before from the
    one buffer every block rewrites in the step (``ref.FWD_BUFFER_FAULT``,
    which the card's lockstep blocks pass, and the emulation's block
    order fails): each fails the ragged bf16 case (slow gates, a state,
    heads of unlike scales) and the h 2 one."""
    lib = _fault_lib(libs, fault)
    for case in (FWD_CASES[1], FWD_CASES[2]):
        ok = _forward_ok(lib, case)
        assert not ok["h"], (fault, case, ok)


def test_emulated_cooperative_launch_refuses_a_grid_too_large(libs):
    """A cooperative grid larger than the multiprocessors can hold is
    refused (82, cudaErrorCooperativeLaunchTooLarge), as the card refuses
    one, and the wrapper raises on any nonzero code; a grid that fits
    meets at its barrier."""
    assert libs["fwd"].sl_barrier(4, 32, 1, None) == 82
    assert libs["fwd"].sl_barrier(3, 32, 5, None) == 0


@pytest.mark.parametrize("b,h,bwd,want", [
    (2, 4, False, {"jb": 22, "blocks": 3, "bt": 2}),
    (40, 4, False, {"jb": 22, "blocks": 3, "bt": 16}),
    (2, 4, True, {"jb": 22, "blocks": 3, "bt": 2, "seg": 2}),
    (2, 2, True, {"jb": 22, "blocks": 3, "bt": 2, "seg": 2})])
def test_emulated_plan(libs, b, h, bwd, want):
    got = SO.plan(libs["bwd" if bwd else "fwd"], b, 64, h, torch.float32,
                  bwd=bwd)
    assert {k: got[k] for k in want} == want
    assert got["smem"] <= 200 * 1024


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------
def _grad_close(got, want):
    scale = max(1.0, want.abs().max().item())
    return torch.allclose(got.float(), want.float(), atol=1e-4 * scale,
                          rtol=1e-4)


def _backward_ok(libs, case, final):
    """The backward kernel (through the forward kernel's histories) and
    the wrapper's dr against autograd of the plain version, under loss
    sum(y dy) (+ the final state's leaves weighted, with ``final``)."""
    (gx, r, bf, st), y, fin, hist = _forward(libs["fwd"], case)
    gen = torch.Generator().manual_seed(5)
    dy = torch.randn(y.shape, generator=gen)
    dfin = {k: (torch.randn(fin[k].shape, generator=gen) if final else None)
            for k in KEYS}
    err, dg, dbf, dst = SO.call_bwd(libs["bwd"], r, bf, st, hist, dy, dfin,
                                    None, threads=THREADS)
    assert err == 0
    ref = SR.slstm_grads(gx, r, bf, st, case[3], dy, dfin)
    h_before = torch.cat([st["h"][:, None], y[:, :-1]], dim=1)
    dr = SO.recurrent_grad(h_before, dg, case[3]).to(r.dtype)
    ok = {"dgx": _grad_close(dg, ref["gx"]), "dbf": _grad_close(dbf,
                                                                ref["bf"])}
    ok.update({f"d{k}": _grad_close(dst[k], ref["state"][k]) for k in KEYS})
    if r.dtype == torch.bfloat16:   # one bf16 unit of the larger
        ok["dr"] = torch.allclose(dr.float(), ref["r"].float(), rtol=2 ** -7,
                                  atol=2 ** -7 * ref["r"].float().abs().max()
                                  .item())
    else:
        ok["dr"] = _grad_close(dr, ref["r"])
    return ok


# (case, the final state's gradients given)
BWD_CASES = [(FWD_CASES[0], False), (FWD_CASES[1], True),
             (FWD_CASES[2], True), (FWD_CASES[3], True),
             (FWD_CASES[4], False)]


@pytest.mark.parametrize("case,final", BWD_CASES)
def test_emulated_slstm_bwd_matches_autograd_of_plain(libs, case, final):
    ok = _backward_ok(libs, case, final)
    assert all(ok.values()), ok


def test_emulated_slstm_bwd_reruns_bit_equal(libs):
    (gx, r, bf, st), y, fin, hist = _forward(libs["fwd"], FWD_CASES[2])
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    runs = [SO.call_bwd(libs["bwd"], r, bf, st, hist, dy, {}, None,
                        threads=THREADS) for _ in range(2)]
    assert runs[0][0] == runs[1][0] == 0
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][2], runs[1][2])
    assert all(torch.equal(runs[0][3][k], runs[1][3][k]) for k in KEYS)


def test_emulated_backward_plan_mirrors_the_smem_layout(libs):
    """sl_bwd_plan's bytes: R's rows (4 hd + 16 elements each), then dg's
    segments and R^T dg per staged row."""
    p = SO.plan(libs["bwd"], 3, 64, 4, torch.bfloat16, bwd=True)
    hd = 16
    rows = -(-p["jb"] * (4 * hd + 16) * 2 // 16) * 16
    assert p["smem"] == rows + p["bt"] * (p["seg"] * 4 * hd + p["jb"]) * 4
    out = (ctypes.c_int * 5)()
    assert libs["bwd"].sl_bwd_plan(3, 64, 5, 1, ctypes.addressof(out)) != 0
