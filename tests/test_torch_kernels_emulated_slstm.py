"""The slstm kernels (``kernels/slstm/csrc/slstm.cu`` and
``slstm_bwd.cu``) on the CPU emulation of the CUDA subset
(``tests/cuda_emu/emu.h``), against their plain version and its
autograd at xlstm's reduced width (d 64).  Every output starts as NaN
(``ops.call`` / ``ops.call_bwd`` with ``fill``), so an element the kernel
does not write shows.

Both are persistent grids launched cooperatively whose blocks hand each
step's values to each other through a ring of step-tagged words
(``kernels/include/scan_ring.cuh``).  The emulation runs every block of
such a launch at once but gives the turn to one block at a time: a block
runs until a word it polls is not yet tagged, then passes the turn on, so
a consumer that does not wait for its tag reads the word before it is
written.  The translation and the build are
``test_torch_kernels_emulated``'s; this file builds only the slstm
sources, so that the test workers run it beside that one.  The blocks
run with 64 threads (the card's 256 would only slow the emulation), so
that a warp holds 6 slots of R, 4 of them in registers in bf16 (2 in
f32) and the rest in shared memory; one test runs 128 threads, where
every bf16 slot is in registers, as at xlstm-1.3b on the card.  They
run over 3 multiprocessors: 3 blocks of 22, 22 and 20 indices, whose
indices span two heads each.  Tolerances: h, the final state and the
histories atol 2e-5 (f32: the recurrent product sums hd terms in another
order than the plain einsum); gradients atol 1e-4 times their largest magnitude (at
least 1) / rtol 1e-4 (the plain version sums them in autograd's order);
dr in r's dtype against the plain autograd's, one bf16 unit for bf16.
Needs g++ with C++20; the tests skip without it.
"""
import ctypes
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

import test_torch_kernels_emulated as E
from repro_torch.kernels.slstm import ops as SO
from repro_torch.kernels.slstm import ref as SR

torch.set_num_threads(2)   # several test workers share the cores

THREADS = 64
KEYS = SR.STATE_KEYS
# a copy of slstm.cu whose cells publish h tagged one step ahead, so that
# no consumer ever sees the tag it waits for, with a short poll bound
TRAP_FAULTS = [("ring::word((unsigned)(v + 1), hy)",
                "ring::word((unsigned)(v + 2), hy)"),
               ("POLL_LIMIT = 1ll << 26;", "POLL_LIMIT = 64;")]


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


def _mutant(libs, source, faults, name, sig):
    text = source.read_text()
    for old, new in faults:
        assert text.count(old) == 1, "the planted fault's line moved"
        text = text.replace(old, new)
    return E.build(text, SO._SOURCE.parent, libs["out"], name, sig)


def _forward(lib, case, keep=True, threads=THREADS):
    b, length, d, h, gates, state, rdtype = case
    ins = SR.slstm_inputs(b, length, d, h, seed=length + 7 * b + h,
                          gates=gates, state=state, rdtype=rdtype)
    err, y, fin, hist = SO.call(lib, *ins, keep, None, threads=threads,
                                fill=float("nan"))
    assert err == 0
    return ins, y, fin, hist


def _forward_ok(lib, case, threads=THREADS):
    """Whether h, each final state leaf and each history pass."""
    ins, y, fin, hist = _forward(lib, case, threads=threads)
    yr, fr, hr = SR.slstm_scan(*ins, case[3], keep=True)
    ok = {"h": torch.allclose(y, yr, atol=2e-5, rtol=0)}
    ok.update({k: torch.allclose(fin[k], fr[k], atol=2e-5, rtol=1e-5)
               for k in KEYS})
    ok.update({f"hist_{k}": torch.allclose(hist[k], hr[k], atol=2e-5,
                                           rtol=1e-5) for k in hr})
    return ok


# (B, L, d, h, gates, state, r dtype): training's shapes scaled down, a
# ragged length from a drawn state with slow forget gates in bf16,
# another head count, decode (L 1) from a state, 7 rows (tiles of the 2
# a block's 64 threads hold, or of 5 at 128), one row at hd 128 (d 128, one head: the
# ring's words staged as they lie), and 8 heads (hd 8: a head's 4 hd words
# come from some blocks only, so the backward's ring rows carry a
# sentinel word a block)
FWD_CASES = [(2, 16, 64, 4, "model", False, torch.float32),
             (1, 13, 64, 4, "slow", True, torch.bfloat16),
             (3, 9, 64, 2, "slow", True, torch.float32),
             (2, 1, 64, 4, "model", True, torch.bfloat16),
             (7, 3, 64, 4, "model", True, torch.float32),
             (1, 6, 128, 1, "slow", False, torch.bfloat16),
             (2, 5, 64, 8, "slow", True, torch.float32)]


@pytest.mark.parametrize("case", FWD_CASES)
def test_emulated_slstm_matches_plain(libs, case):
    ok = _forward_ok(libs["fwd"], case)
    assert all(ok.values()), ok


def test_emulated_slstm_holds_r_in_registers_only_at_128_threads(libs):
    """At 128 threads a warp takes 3 slots of R, in bf16 all of them in
    registers (as at xlstm-1.3b on the card); the ragged bf16 case and 7
    rows in tiles of 5 agree there too, and the backward."""
    plan = SO.plan(libs["fwd"], 1, 64, 4, torch.bfloat16, threads=128)
    assert (plan["slots"], plan["reg_slots"]) == (3, 4)
    for case in (FWD_CASES[1], FWD_CASES[4]):
        ok = _forward_ok(libs["fwd"], case, threads=128)
        assert all(ok.values()), (case, ok)
    ok = _backward_ok(libs, FWD_CASES[1], True, threads=128)
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


@pytest.mark.parametrize("fault", sorted(SR.FWD_FAULTS))
def test_emulated_slstm_checks_catch_planted_faults(libs, fault):
    """slstm.cu with the recurrent term laid out gate-major, without the
    carried state's rescale, or with a consumer that takes a ring word
    whatever its tag (``ref.FWD_FAULTS``; its outputs start as NaN):
    each fails the ragged bf16 case (slow gates, a state, heads of unlike
    scales) and the h 2 one."""
    lib = _mutant(libs, SO._SOURCE, [SR.FWD_FAULTS[fault]],
                  f"slstm_{fault}", SO._SIG)
    for case in (FWD_CASES[1], FWD_CASES[2]):
        ok = _forward_ok(lib, case)
        assert not ok["h"], (fault, case, ok)


def test_emulated_cooperative_launch_refuses_a_grid_too_large(libs):
    """A cooperative grid larger than the multiprocessors can hold is
    refused (82, cudaErrorCooperativeLaunchTooLarge), as the card refuses
    one, and the wrapper raises on any nonzero code; a grid that fits
    meets at its barrier, and runs the exchange alone in both forms."""
    assert libs["fwd"].sl_barrier(4, 32, 1, None) == 82
    assert libs["fwd"].sl_barrier(3, 32, 5, None) == 0
    ring = torch.zeros(2 * 2 * 64, dtype=torch.int64)
    flags = torch.zeros(4, dtype=torch.int32)
    for form in SO.EXCHANGE_FORMS.values():
        assert libs["fwd"].sl_exchange(
            3, 64, 64, 22, 2, 5, form, ring.data_ptr(), flags.data_ptr(),
            None) == 0
        assert libs["fwd"].sl_exchange(
            4, 64, 64, 16, 2, 5, form, ring.data_ptr(), flags.data_ptr(),
            None) == 82


def test_emulated_exchange_wait_past_its_bound_traps(libs):
    """A consumer whose word never carries the tag it waits for (a copy
    whose cells publish one step ahead) stops at its poll bound with
    __trap(), reported as an error (here the process's, on the card the
    launch's), and does not hang."""
    lib = _mutant(libs, SO._SOURCE, TRAP_FAULTS, "slstm_trap", SO._SIG)
    so_path = lib._name
    script = textwrap.dedent(f"""
        import ctypes, torch
        from repro_torch.kernels import _build
        from repro_torch.kernels.slstm import ops, ref
        lib = _build.bind(ctypes.CDLL({so_path!r}), ops._SIG)
        ins = ref.slstm_inputs(1, 4, 64, 4, seed=0)
        err, *_ = ops.call(lib, *ins, False, None, threads=64)
        print("returned", err)
    """)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(SO.__file__)))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0, proc.stdout
    assert "__trap" in proc.stderr, proc.stderr[-2000:]
    assert "returned" not in proc.stdout


@pytest.mark.parametrize("b,h,bwd,threads,want", [
    (2, 4, False, 128, {"jb": 22, "blocks": 3, "bt": 2, "jbp": 24,
                        "tasks": 12, "slots": 3, "ring_words": 256}),
    (17, 4, False, 64, {"bt": 2, "ring_words": 256}),
    (40, 4, False, 128, {"jb": 22, "blocks": 3, "bt": 5, "slots": 3}),
    (2, 4, True, 128, {"jb": 22, "blocks": 3, "bt": 2, "seg": 2,
                       "tasks": 3, "slots": 1, "ring_words": 1024}),
    (2, 2, True, 128, {"jb": 22, "blocks": 3, "bt": 2, "seg": 2}),
    (2, 4, False, 64, {"bt": 2, "slots": 6, "reg_slots": 2})])
def test_emulated_plan(libs, b, h, bwd, threads, want):
    got = SO.plan(libs["bwd" if bwd else "fwd"], b, 64, h, torch.float32,
                  bwd=bwd, threads=threads)
    assert {k: got[k] for k in want} == want
    assert got["smem"] <= 200 * 1024 and got["threads"] == threads


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------
def _grad_close(got, want):
    scale = max(1.0, want.abs().max().item())
    return torch.allclose(got.float(), want.float(), atol=1e-4 * scale,
                          rtol=1e-4)


def _backward_ok(libs, case, final, bwd_lib=None, threads=THREADS):
    """The backward kernel (through the forward kernel's histories) and
    the wrapper's dr against autograd of the plain version, under loss
    sum(y dy) (+ the final state's leaves weighted, with ``final``)."""
    (gx, r, bf, st), y, fin, hist = _forward(libs["fwd"], case,
                                             threads=threads)
    gen = torch.Generator().manual_seed(5)
    dy = torch.randn(y.shape, generator=gen)
    dfin = {k: (torch.randn(fin[k].shape, generator=gen) if final else None)
            for k in KEYS}
    err, dg, dbf, dst = SO.call_bwd(bwd_lib or libs["bwd"], r, bf, st, hist,
                                    dy, dfin, None, threads=threads,
                                    fill=float("nan"))
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
             (FWD_CASES[4], False), (FWD_CASES[5], True),
             (FWD_CASES[6], True)]


@pytest.mark.parametrize("case,final", BWD_CASES)
def test_emulated_slstm_bwd_matches_autograd_of_plain(libs, case, final):
    ok = _backward_ok(libs, case, final)
    assert all(ok.values()), ok


def test_emulated_slstm_bwd_reruns_bit_equal(libs):
    (gx, r, bf, st), y, fin, hist = _forward(libs["fwd"], FWD_CASES[2])
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    runs = [SO.call_bwd(libs["bwd"], r, bf, st, hist, dy, {}, None,
                        threads=THREADS, fill=float("nan")) for _ in range(2)]
    assert runs[0][0] == runs[1][0] == 0
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][2], runs[1][2])
    assert all(torch.equal(runs[0][3][k], runs[1][3][k]) for k in KEYS)


def test_emulated_slstm_bwd_checks_catch_the_carry_fault(libs):
    """slstm_bwd.cu with the carry dc passed on without its factor fi
    (``ref.BWD_CARRY_FAULT``) fails dgx on the ragged bf16 case and the
    h 2 one (slow gates from a state, the final state's gradients)."""
    lib = _mutant(libs, SO._BWD_SOURCE, [SR.BWD_CARRY_FAULT],
                  "slstm_bwd_carry", SO._BWD_SIG)
    for case in (BWD_CASES[1], BWD_CASES[2]):
        ok = _backward_ok(libs, *case, bwd_lib=lib)
        assert not ok["dgx"], (case, ok)


@pytest.mark.parametrize("threads,rdtype", [(128, torch.bfloat16),
                                            (64, torch.float32)])
def test_emulated_backward_plan_mirrors_the_smem_layout(libs, threads,
                                                        rdtype):
    """sl_bwd_plan's bytes: dg's segments of a tile (seg chunks of 4 hd
    padded to 128, f32), the tasks' partial sums, the cells' prefetched
    values (two of 8 a thread), each index's and group's offset, and R's
    slots past those a thread holds in registers (CW 8 x 32 lanes x 4
    f32 each: 4 slots in bf16, 2 in f32)."""
    p = SO.plan(libs["bwd"], 3, 64, 4, rdtype, bwd=True, threads=threads)

    def a16(x):
        return -(-x // 16) * 16
    kp = -(-4 * 16 // 128) * 128
    want = (a16(p["bt"] * p["seg"] * kp * 4) + a16(p["tasks"] * p["bt"] * 32)
            + 2 * threads * 8 * 4 + a16(p["jbp"] * 4)
            + a16(p["jbp"] // 8 * 4)
            + threads // 32 * max(0, p["slots"] - p["reg_slots"]) * 8 * 32
            * 4 * 4)
    assert p["reg_slots"] == (4 if rdtype == torch.bfloat16 else 2)
    assert p["smem"] == want
    out = (ctypes.c_int * 16)()
    assert libs["bwd"].sl_bwd_plan(3, 64, 5, 1, threads,
                                   ctypes.addressof(out)) != 0
