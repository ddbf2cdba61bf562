"""The hand-written CUDA kernels, run on the CPU through an emulation of
the CUDA subset they use (``tests/cuda_emu/emu.h``), against their plain
PyTorch versions at small shapes.

There is no GPU and no nvcc here, so this is where a kernel's indexing,
its warp-level fragment layouts (ldmatrix, mma.sync), its masks and its
cp.async pipeline are checked before a card sees it.  Each source is
translated (the inline-PTX primitives of the shared ``mma_bf16.cuh``
replaced by emulated ones, launches rewritten into calls), compiled with g++ and
loaded with ctypes; the C interface is the one the wrappers call.  The
emulation sums products in another order than the card, so the
tolerances are the card tests' (``tests/test_torch_kernels_cuda.py``).
Needs g++ with C++20; the tests skip without it.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as FO
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.kernels.mamba_scan import ops as SO
from repro_torch.kernels.mamba_scan import ref as SR
from repro_torch.kernels.mlstm import ops as MO
from repro_torch.kernels.mlstm import ref as MR
from repro_torch.kernels.moe_gmm import ops as GO
from repro_torch.kernels.moe_gmm import ref as GR

torch.set_num_threads(2)   # several test workers share the cores

EMU = Path(__file__).resolve().parent / "cuda_emu"
# the primitives mma_bf16.cuh, wgmma_bf16.cuh and scan_ring.cuh write in
# inline PTX (and mbar_wait, a loop over one); emu.h defines them
PTX_FNS = {"smem_u32", "cp_async16", "cp_async4", "cp_async_commit",
           "cp_async_wait", "ldmatrix_x4", "ldmatrix_x4_trans", "mma_bf16",
           "fence", "commit_group", "wait_group", "mma_n64", "mma_n128",
           "mma_n256", "mbar_init", "fence_barrier_init", "fence_proxy_async",
           "mbar_expect_tx", "mbar_arrive", "mbar_try_wait", "mbar_wait",
           "tma_load_3d", "tma_store_3d", "bulk_commit", "bulk_wait_read",
           "warpgroup_sync", "setmaxnreg_dec", "setmaxnreg_inc",
           "ld_relaxed_u64", "st_relaxed_u64", "ld_acquire_u32",
           "st_release_u32", "poll_pause", "opaque32", "opaque64",
           "fma_lo", "fma_hi"}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# mlstm's h pass with only the product of C's first bf16 part, and
# mamba_scan's y with only that of the state S's first part: each rounded
# once (the faults the card tests plant too)
MLSTM_ROUND_FAULT = (
    "          for (int p = 1; p < NPART; ++p) {     // C's lower parts\n",
    "          for (int p = 1; p < 1; ++p) {     // C's lower parts\n")
SCAN_ROUND_FAULT = (
    "for (int k = 0; k < NPART; ++k) {   // the state's parts",
    "for (int k = 0; k < 1; ++k) {   // the state's parts")


def _drop_ptx(text: str) -> str:
    """``text`` without the definitions of the PTX_FNS functions."""
    pat = re.compile(r"(template <[^<>\n]*>\n)?__device__ __forceinline__ "
                     r"[\w ]+? (\w+)\(")
    out, i = [], 0
    for m in pat.finditer(text):
        if m.group(2) not in PTX_FNS or m.start() < i:
            continue
        depth, k = 0, text.index("{", m.end())
        while True:
            depth += {"{": 1, "}": -1}.get(text[k], 0)
            if depth == 0:
                break
            k += 1
        out.append(text[i:m.start()])
        i = k + 1
    return "".join(out) + text[i:]


def translate(source: str, include_dir: Path) -> str:
    """A kernel source as C++ over emu.h; its ``#include "..."`` found
    beside it (``include_dir``) or in the build's shared include dir,
    each header inlined once (its own includes too)."""
    seen = set()

    def inline(m):
        if m.group(1) in seen:
            return ""
        seen.add(m.group(1))
        for where in (include_dir, _build.INCLUDE_DIR):
            if (where / m.group(1)).exists():
                return re.sub(r'#include "([\w.]+)"', inline, _drop_ptx(
                    (where / m.group(1)).read_text()))
        raise FileNotFoundError(m.group(1))
    text = re.sub(r'#include "([\w.]+)"', inline, source)
    text = re.sub(r"#include <(cuda(_bf16|_runtime)?|cooperative_groups)"
                  r"\.h>|#pragma once", "", text)
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) "
                  r"(\w+)\[\];", r"\1* \2 = (\1*)emu::smem();", text)
    text = re.sub(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\((.*?)\);",
                  lambda m: f"emu::launch({m.group(2)}, [=]() "
                            f"{{ {m.group(1)}({m.group(3)}); }});",
                  text, flags=re.S)
    return '#include "emu.h"\n' + text


def build(source: str, include_dir: Path, out_dir: Path, name: str,
          signatures) -> ctypes.CDLL:
    cpp = out_dir / f"{name}.cpp"
    cpp.write_text(translate(source, include_dir))
    so = out_dir / f"lib{name}.so"
    proc = subprocess.run(
        [shutil.which("g++"), "-std=c++20", "-O1", "-shared", "-fPIC",
         "-pthread", f"-I{EMU}", "-o", str(so), str(cpp)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to build the emulated kernels")
    out = tmp_path_factory.mktemp("emu")
    csrc = FO._CSRC
    return {
        "fwd": build((csrc / "flash_attention.cu").read_text(), csrc, out,
                     "fwd", FO._FWD_SIG),
        "bwd": build((csrc / "flash_attention_bwd.cu").read_text(), csrc,
                     out, "bwd", FO._BWD_SIG),
        "gmm": build(GO._SOURCE.read_text(), GO._SOURCE.parent, out, "gmm",
                     GO._SIG),
        "gmm_bwd": build(GO._BWD_SOURCE.read_text(), GO._SOURCE.parent, out,
                         "gmm_bwd", GO._BWD_SIG),
        "mlstm": build(MO._SOURCE.read_text(), MO._SOURCE.parent, out,
                       "mlstm", MO._SIG),
        "scan": build(SO._SOURCE.read_text(), SO._SOURCE.parent, out,
                      "scan", SO._SIG),
        "scan_bwd": build(SO._BWD_SOURCE.read_text(), SO._SOURCE.parent,
                          out, "scan_bwd", SO._BWD_SIG),
        "mlstm_bwd": build(MO._BWD_SOURCE.read_text(), MO._SOURCE.parent,
                           out, "mlstm_bwd", MO._BWD_SIG),
        "out": out}


def _qkv(b, h, kv, s, hd, dtype, seed, rising=False):
    """(B, H, S, hd) q and (B, KV, S, hd) k, v; with ``rising`` the keys
    grow with position, so each row's maximum rises across key tiles."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, h, s, hd), generator=gen)
    k = torch.randn((b, kv, s, hd), generator=gen)
    if rising:
        q, k = q.abs(), k.abs() * (1 + torch.arange(s)[:, None] / 32)
    v = torch.randn((b, kv, s, hd), generator=gen)
    return tuple(x.to(dtype) for x in (q, k, v))


def _forward(lib, q, k, v, causal, window):
    """(out, lse, o32): the output, its log-sum-exp and the output in f32
    before its rounding (``out`` itself for f32)."""
    b, h, s, hd = q.shape
    out = torch.empty_like(q)
    o32 = torch.empty(q.shape) if q.dtype != torch.float32 else out
    lse = torch.empty((b, h, s))
    err = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), o32.data_ptr() if o32 is not out
                         else None, lse.data_ptr(), b, h, k.shape[1], s, hd,
                         hd ** -0.5, int(causal), window,
                         FO._DTYPES[q.dtype], None)
    assert err == 0
    return out, lse, o32


def _lse_ref(q, k, causal, window):
    s, g = q.shape[2], q.shape[1] // k.shape[1]
    logits = q.float() @ k.float().repeat_interleave(g, 1).transpose(-1, -2)
    i = torch.arange(s)
    ok = torch.ones((s, s), dtype=torch.bool)
    if causal:
        ok &= i[:, None] >= i[None, :]
    if window:
        ok &= (i[:, None] - i[None, :]) < window
    return torch.logsumexp((logits * q.shape[-1] ** -0.5)
                           .masked_fill(~ok, -1e30), -1)


FWD_CASES = [  # (B, H, KV, S, hd, causal, window, dtype, rising)
    (1, 2, 1, 136, 64, True, 0, torch.bfloat16, False),
    (1, 2, 1, 136, 128, True, 0, torch.bfloat16, False),
    (1, 2, 1, 200, 64, True, 48, torch.bfloat16, False),
    (1, 2, 1, 150, 64, False, 0, torch.bfloat16, False),
    (2, 2, 1, 256, 64, True, 0, torch.bfloat16, True),
    (1, 2, 1, 100, 64, True, 0, torch.float32, False),
    (1, 2, 1, 130, 128, True, 40, torch.float32, False),
    # group 1 (as many KV heads as query heads: whisper-small's 12 / 12)
    (1, 2, 2, 136, 64, True, 0, torch.bfloat16, False),
    (1, 2, 2, 100, 64, True, 0, torch.float32, False),
    # groups 3 and 16 at hd 128 (24 / 8 and 32 / 2 heads)
    (1, 3, 1, 136, 128, True, 0, torch.bfloat16, False),
    (1, 3, 1, 100, 128, True, 0, torch.float32, False),
    (1, 16, 1, 72, 128, True, 0, torch.bfloat16, False),
]


@pytest.mark.parametrize("b,h,kv,s,hd,causal,window,dtype,rising", FWD_CASES)
def test_emulated_forward_matches_plain(libs, b, h, kv, s, hd, causal,
                                        window, dtype, rising):
    q, k, v = _qkv(b, h, kv, s, hd, dtype, s + hd, rising)
    out, lse, o32 = _forward(libs["fwd"], q, k, v, causal, window)
    ref = FR.attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert torch.equal(o32.to(dtype), out)
    torch.testing.assert_close(lse, _lse_ref(q, k, causal, window),
                               atol=1e-4, rtol=1e-5)


BWD_CASES = [  # (B, H, KV, S, hd, window, dtype, rising)
    (1, 2, 1, 136, 64, 0, torch.bfloat16, False),
    (1, 2, 1, 136, 128, 0, torch.bfloat16, False),
    (1, 2, 1, 200, 64, 48, torch.bfloat16, False),
    (1, 2, 2, 130, 128, 40, torch.bfloat16, False),
    (1, 2, 1, 256, 64, 0, torch.bfloat16, True),
    (1, 2, 1, 256, 128, 0, torch.bfloat16, True),
    (1, 2, 1, 100, 64, 0, torch.float32, False),
    # group 1
    (1, 2, 2, 136, 64, 0, torch.bfloat16, False),
    (1, 2, 2, 100, 64, 0, torch.float32, False),
    # groups 3 and 16 at hd 128
    (1, 3, 1, 136, 128, 0, torch.bfloat16, False),
    (1, 16, 1, 72, 128, 0, torch.bfloat16, False),
]


@pytest.mark.parametrize("b,h,kv,s,hd,window,dtype,rising", BWD_CASES)
def test_emulated_backward_matches_autograd_of_plain(libs, b, h, kv, s, hd,
                                                     window, dtype, rising):
    """With ``rising`` the all-positive q and k make every dS row sum to
    zero over keys of a large common size, which a bf16 rounding of dS
    as an operand would not survive."""
    q, k, v = _qkv(b, h, kv, s, hd, dtype, s + window, rising)
    out, lse, o32 = _forward(libs["fwd"], q, k, v, True, window)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(
        7)).to(dtype)
    grads = [torch.empty_like(t) for t in (q, k, v)]
    scratch = torch.empty((b, h, s))
    err = libs["bwd"].fa_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o32.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
        *(g.data_ptr() for g in grads), b, h, kv, s, hd, hd ** -0.5, 1,
        window, FO._DTYPES[dtype], None)
    assert err == 0
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = FR.attention_ref(*leaves, causal=True, window=window)
    for g, r in zip(grads, torch.autograd.grad(ref, leaves, dout)):
        torch.testing.assert_close(g.float(), r.float(), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype])


def _gmm(lib, x, w1, w2, w3, act):
    """y from the emulated mg_ffn (with the bf16 route's workspace)."""
    e, m, d = x.shape
    ff = w1.shape[-1]
    y = torch.empty_like(x)
    h = torch.empty(GO.workspace_shape(e, m, ff), dtype=torch.bfloat16)
    err = lib.mg_ffn(x.data_ptr(), w1.data_ptr(), w3.data_ptr(),
                     w2.data_ptr(), h.data_ptr(), y.data_ptr(), e, m, d, ff,
                     GO.ACTS.index(act), GO._DTYPES[x.dtype], None)
    assert err == 0
    return y


@pytest.mark.parametrize("e,m,d,ff,act,dtype", [
    (2, 40, 1100, 96, "silu", torch.float32),     # a ragged second slab
    (2, 40, 1100, 96, "silu", torch.bfloat16),    # d unaligned: element loads
    (2, 33, 2100, 70, "gelu", torch.float32),     # three slabs
    (3, 10, 64, 128, "silu", torch.float32),      # one slab
    # bf16, the tensor-core route: decode tiles (M <= 16), aligned
    (3, 10, 64, 128, "silu", torch.bfloat16),
    # ragged ff (200 -> h rows of 256) and d-tile (136), M 2 and 1 row
    (2, 2, 136, 200, "silu", torch.bfloat16),
    (1, 1, 72, 64, "gelu", torch.bfloat16),
    # prefill tiles: ragged M (100 = 64 + 36), gelu, ff and d unaligned
    (2, 100, 128, 192, "silu", torch.bfloat16),
    (2, 33, 130, 70, "gelu", torch.bfloat16),
    (1, 17, 64, 96, "silu", torch.bfloat16)])
def test_emulated_moe_gmm_matches_plain(libs, e, m, d, ff, act, dtype):
    gen = torch.Generator().manual_seed(d)
    x = (torch.randn((e, m, d), generator=gen) * 0.5).to(dtype)
    w1, w3 = ((torch.randn((e, d, ff), generator=gen) * 0.05).to(dtype)
              for _ in range(2))
    w2 = (torch.randn((e, ff, d), generator=gen) * 0.05).to(dtype)
    y = _gmm(libs["gmm"], x, w1, w2, w3, act)
    ref = GR.expert_ffn_ref(x, w1, w2, w3, act=act)
    tol = GMM_TOL[dtype]
    torch.testing.assert_close(y.float(), ref.float(), atol=tol, rtol=tol)


GMM_COMMON = [(2, 24, 64, 128), (2, 8, 64, 128)]    # prefill and decode


@pytest.mark.parametrize("e,m,d,ff", GMM_COMMON)
def test_emulated_moe_gmm_keeps_h_precision(libs, e, m, d, ff):
    """bf16 inputs whose h has a large common part (ref.common_part_inputs):
    the kernel's h w2 from h's hi + lo bf16 pair passes the tolerance."""
    ins = GR.common_part_inputs(e, m, d, ff, dtype=torch.bfloat16, seed=m)
    y = _gmm(libs["gmm"], *ins, "silu")
    ref = GR.expert_ffn_ref(*ins)
    tol = GMM_TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), ref.float(), atol=tol, rtol=tol)


def test_emulated_moe_gmm_checks_catch_h_rounded_once(libs):
    """moe_gmm.cu without the h_lo product (h rounded once to bf16 before
    h w2) fails the common-part cases."""
    old, new = GR.FWD_ROUND_FAULT
    source = GO._SOURCE.read_text()
    assert source.count(old) == 1
    lib = build(source.replace(old, new), GO._SOURCE.parent, libs["out"],
                "gmm_fault", GO._SIG)
    tol = GMM_TOL[torch.bfloat16]
    for e, m, d, ff in GMM_COMMON:
        ins = GR.common_part_inputs(e, m, d, ff, dtype=torch.bfloat16,
                                    seed=m)
        y = _gmm(lib, *ins, "silu")
        ref = GR.expert_ffn_ref(*ins)
        assert not torch.allclose(y.float(), ref.float(), atol=tol, rtol=tol)


def _gmm_bwd(lib, x, w1, w2, w3, dy, act):
    """(dx, dw1, dw2, dw3) from the emulated mg_ffn_bwd, through the
    design ``GO.bwd_design`` names."""
    e, m, d = x.shape
    ff = w1.shape[-1]
    dx, dw1, dw2 = (torch.empty_like(t) for t in (x, w1, w2))
    dw3 = torch.empty_like(w3) if act == "silu" else torch.zeros_like(w3)
    ws = torch.empty(GO.bwd_workspace_shape(e, m, ff, x.dtype),
                     dtype=x.dtype)
    ptrs = [t.data_ptr() for t in (x, w1, w3, w2, dy, ws, dx, dw1, dw3, dw2)]
    design = GO.bwd_design(e, m, d, ff, x.dtype,
                           all(p % 16 == 0 for p in ptrs))
    err = lib.mg_ffn_bwd(*ptrs, e, m, d, ff, GO.ACTS.index(act),
                         GO._DTYPES[x.dtype], GO.BWD_DESIGNS.index(design),
                         None)
    assert err == 0
    return dx, dw1, dw2, dw3


def _grads_close(got, ref, dtype):
    """Each gradient within the moe_gmm tolerance (``ref.grads_close``)."""
    return GR.grads_close(got, ref, GMM_TOL[dtype])


# (E, M, d, ff, act, dtype) -> the design ops.bwd_design must name
GMM_BWD_DESIGN = {
    # bf16 through wgmma and TMA: ragged M (40 of a 128-row tile) and ff
    # (96 -> workspace rows of 128: two gate-up tiles, one dw tile)
    (2, 40, 64, 96, "silu", torch.bfloat16): "wgmma",
    # M ragged in its tile, ff 200 over four gate-up tiles and two dw
    # tiles, the second ragged; d of one dx tile
    (2, 100, 128, 200, "silu", torch.bfloat16): "wgmma",
    # bf16 that TMA cannot describe, through mma.sync: ff not a multiple
    # of 8, gelu (dw3 = 0)
    (2, 33, 72, 70, "gelu", torch.bfloat16): "mma.sync",
    # d not a multiple of 8
    (1, 17, 130, 64, "silu", torch.bfloat16): "mma.sync",
    # f32 on the CUDA cores
    (2, 40, 64, 96, "silu", torch.float32): "fma",
    (2, 33, 72, 70, "gelu", torch.float32): "fma",
    (1, 70, 130, 66, "silu", torch.float32): "fma",
    # wgmma: gelu (dw3 = 0), d over two dw tiles, ff 192 over three
    # gate-up tiles and two dw tiles (the second's last box past ldh)
    (2, 100, 256, 192, "gelu", torch.bfloat16): "wgmma",
    # M over two tiles and three k-steps of the dw sums (the last ragged)
    (1, 130, 128, 128, "silu", torch.bfloat16): "wgmma",
    # d 192 and ldh 192: boxes wholly past d or ldh are not loaded
    (2, 70, 192, 136, "silu", torch.bfloat16): "wgmma"}


@pytest.mark.parametrize("e,m,d,ff,act,dtype", list(GMM_BWD_DESIGN))
def test_emulated_moe_gmm_bwd_matches_autograd_of_plain(libs, e, m, d, ff,
                                                        act, dtype):
    assert GO.bwd_design(e, m, d, ff, dtype) == \
        GMM_BWD_DESIGN[(e, m, d, ff, act, dtype)]
    gen = torch.Generator().manual_seed(d + ff)
    x = (torch.randn((e, m, d), generator=gen) * 0.5).to(dtype)
    w1, w3 = ((torch.randn((e, d, ff), generator=gen) * 0.05).to(dtype)
              for _ in range(2))
    w2 = (torch.randn((e, ff, d), generator=gen) * 0.05).to(dtype)
    dy = torch.randn((e, m, d), generator=gen).to(dtype)
    got = _gmm_bwd(libs["gmm_bwd"], x, w1, w2, w3, dy, act)
    ref = GR.expert_ffn_grads_ref(x, w1, w2, w3, dy, act=act)
    assert all(g.dtype == dtype for g in got)
    assert all(_grads_close(got, ref, dtype)), _grads_close(got, ref, dtype)
    if act == "gelu":
        assert not got[3].any()
    again = _gmm_bwd(libs["gmm_bwd"], x, w1, w2, w3, dy, act)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_emulated_moe_gmm_bwd_refuses_another_design(libs):
    """The C entry takes ``bwd_design``'s rule and refuses a call that
    names another design."""
    ts = [torch.zeros(s, dtype=torch.bfloat16) for s in (
        (1, 8, 64), (1, 64, 64), (1, 64, 64), (1, 64, 64), (1, 8, 64),
        GO.bwd_workspace_shape(1, 8, 64), (1, 8, 64), (1, 64, 64),
        (1, 64, 64), (1, 64, 64))]
    assert GO.bwd_design(1, 8, 64, 64, torch.bfloat16) == "wgmma"
    for design in ("mma.sync", "fma"):
        assert libs["gmm_bwd"].mg_ffn_bwd(
            *(t.data_ptr() for t in ts), 1, 8, 64, 64, 0, 1,
            GO.BWD_DESIGNS.index(design), None) != 0


# (E, M, d, ff) of the backward's common-part cases, both through wgmma:
# shapes at which one bf16 rounding of h fails dw2 by 1.5-2x its
# tolerance (a float64 model of the sums; at granite's training shape 3x)
GMM_BWD_COMMON = [(1, 64, 256, 64), (1, 100, 256, 128)]
# The wgmma design without one consumer's wait on a stage's full barrier:
# its products read the stage before its TMA boxes land.
BWD_WAIT_FAULT = ("    wg::mbar_wait(full + ring.stage, ring.phase);\n", "")


def _bwd_common(e, m, d, ff):
    ins = GR.common_part_inputs(e, m, d, ff, dtype=torch.bfloat16, seed=m)
    dy = GR.common_part_grad(e, m, d, dtype=torch.bfloat16, seed=m + 1)
    return ins, dy, GR.expert_ffn_grads_ref(*ins, dy)


@pytest.mark.parametrize("e,m,d,ff", GMM_BWD_COMMON)
def test_emulated_moe_gmm_bwd_keeps_h_precision(libs, e, m, d, ff):
    """bf16 inputs whose h has a large common part and a dy whose columns
    sum to zero over M: dw2 from h's hi + lo pair passes, and dg and du,
    rounded once, pass dx, dw1 and dw3; a rerun is bit-equal."""
    assert GO.bwd_design(e, m, d, ff, torch.bfloat16) == "wgmma"
    ins, dy, ref = _bwd_common(e, m, d, ff)
    got = _gmm_bwd(libs["gmm_bwd"], *ins, dy, "silu")
    assert all(_grads_close(got, ref, torch.bfloat16))
    again = _gmm_bwd(libs["gmm_bwd"], *ins, dy, "silu")
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _bwd_fault_lib(libs, fault, name):
    old, new = fault
    source = GO._BWD_SOURCE.read_text()
    assert source.count(old) == 1
    return build(source.replace(old, new), GO._SOURCE.parent, libs["out"],
                 name, GO._BWD_SIG)


def test_emulated_moe_gmm_bwd_checks_catch_h_rounded_once(libs):
    """moe_gmm_bwd.cu without the h_lo wgmma (h rounded once to bf16 in
    dw2) fails dw2 in the common-part cases, and only dw2."""
    lib = _bwd_fault_lib(libs, GR.BWD_ROUND_FAULT, "gmm_bwd_fault")
    for e, m, d, ff in GMM_BWD_COMMON:
        ins, dy, ref = _bwd_common(e, m, d, ff)
        got = _gmm_bwd(lib, *ins, dy, "silu")
        assert _grads_close(got, ref, torch.bfloat16) == [True, True, False,
                                                          True]


def test_emulated_moe_gmm_bwd_checks_catch_a_missing_wait(libs):
    """moe_gmm_bwd.cu whose consumers do not wait for a stage's TMA boxes
    fails: its products read the stage before the boxes land."""
    lib = _bwd_fault_lib(libs, BWD_WAIT_FAULT, "gmm_bwd_wait_fault")
    for e, m, d, ff in GMM_BWD_COMMON:
        ins, dy, ref = _bwd_common(e, m, d, ff)
        got = _gmm_bwd(lib, *ins, dy, "silu")
        assert not any(_grads_close(got, ref, torch.bfloat16))


def test_emulated_checks_catch_a_missing_rescale(libs):
    """The bf16 forward without the online softmax's rescale (the fault
    the card test plants too) fails the checks above."""
    csrc = FO._CSRC
    source = (csrc / "flash_attention.cu").read_text()
    old, new = ("corr[i] = exp2f(m_r[i] - mx[i]);", "corr[i] = 1.f;")
    assert source.count(old) == 1
    lib = build(source.replace(old, new), csrc, libs["out"], "fwd_fault",
                FO._FWD_SIG)
    for rising in (False, True):
        q, k, v = _qkv(1, 2, 1, 256, 64, torch.bfloat16, 3, rising)
        out, _, _ = _forward(lib, q, k, v, True, 0)
        ref = FR.attention_ref(q, k, v, causal=True)
        assert not torch.allclose(out.float(), ref.float(), atol=2e-2,
                                  rtol=2e-2)


# mlstm: the card tests' gate kinds (tests/test_torch_kernels_cuda.py,
# MLSTM_GATES) and tolerances (_mlstm_tols).
MLSTM_GATES = {"jax": (-1.0, 0.0, 1.0), "slow": (1.0, 4.6, 0.1)}


def _mlstm_inputs(b, length, h, hd, dtype, seed, state, gates, common=False):
    """As the card tests draw them; with ``common`` the initial C has a
    large common part (30 + N(0, 0.3)) that Q C^T cancels (q's mean over
    hd taken out), so a rounding of C as an operand shows in h."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, length, h, hd), generator=gen)
               for _ in range(3))
    if common:
        q = q - q.mean(-1, keepdim=True)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    li = torch.randn((b, length, h), generator=gen) - 1
    sign, mean, std = MLSTM_GATES[gates]
    x = torch.randn((b, length, h), generator=gen) * std + mean
    lf = -torch.nn.functional.softplus(x) if sign < 0 \
        else torch.nn.functional.logsigmoid(x)
    st = None
    if state:
        st = (torch.randn((b, h, hd, hd), generator=gen) * .3
              + (30.0 if common else 0.0),
              torch.randn((b, h, hd), generator=gen) * .3,
              torch.randn((b, h), generator=gen))
    return (q, k, v, li, lf), st


def _mlstm_ok(lib, case, common=False):
    """Whether each of h, C, n and m passes the card tests' tolerance."""
    b, length, h, hd, chunk, state, gates, dtype = case
    ins, st = _mlstm_inputs(b, length, h, hd, dtype, length + hd, state,
                            gates, common)
    err, out, (c, n, m) = MO.call(lib, *ins, st, min(chunk, length), None)
    assert err == 0
    ref, (cr, nr, mr) = MR.mlstm_chunked(*ins, st, chunk)
    tol = {torch.float32: 1e-4, torch.bfloat16: 8e-3}[dtype]
    scale = lambda t: max(1.0, t.float().abs().max().item())
    tols = {"h": (tol * scale(ref), tol), "c": (1e-4 * scale(cr), 1e-3),
            "n": (1e-4 * scale(nr), 1e-3), "m": (1e-3, 0.0)}
    return {name: torch.allclose(got, want, atol=tols[name][0],
                                 rtol=tols[name][1])
            for name, got, want in (("h", out.float(), ref.float()),
                                    ("c", c, cr), ("n", n, nr),
                                    ("m", m, mr))}


MLSTM_CASES = [  # (B, L, H, hd, chunk, state, gates, dtype)
    (1, 256, 2, 64, 64, False, "jax", torch.bfloat16),
    (2, 100, 2, 48, 32, True, "slow", torch.bfloat16),    # ragged, state
    (1, 37, 2, 8, 16, True, "slow", torch.bfloat16),
    (1, 64, 1, 256, 32, True, "slow", torch.bfloat16),    # 2 x 2 C tiles
    (2, 40, 1, 20, 16, True, "slow", torch.bfloat16),     # hd % 8 != 0
    (2, 100, 2, 48, 32, True, "slow", torch.float32)]
MLSTM_COMMON = (1, 130, 1, 64, 128, True, "slow", torch.bfloat16)


@pytest.mark.parametrize("case", MLSTM_CASES)
def test_emulated_mlstm_matches_plain(libs, case):
    ok = _mlstm_ok(libs["mlstm"], case)
    assert all(ok.values()), ok


def test_emulated_mlstm_keeps_c_precision(libs):
    """bf16, an initial C with a large common part: Q C^T from C's bf16
    parts passes."""
    ok = _mlstm_ok(libs["mlstm"], MLSTM_COMMON, common=True)
    assert all(ok.values()), ok


def test_emulated_mlstm_checks_catch_c_rounded_once(libs):
    """mlstm.cu with only C's first part in Q C^T fails the case."""
    old, new = MLSTM_ROUND_FAULT
    source = MO._SOURCE.read_text()
    assert source.count(old) == 1
    lib = build(source.replace(old, new), MO._SOURCE.parent, libs["out"],
                "mlstm_fault", MO._SIG)
    assert not all(_mlstm_ok(lib, MLSTM_COMMON, common=True).values())


# The forward's precision check (ref.precision: h and the final C against
# float64, the plain version as the yardstick), bf16 with slow gates: the
# smallest shape where f32 operands kept in two bf16 parts fail it (one
# chunk of 16 tokens, hd 8), and several chunks of two heads, where h
# fails too.
MLSTM_PRECISION = [(1, 16, 1, 8, 16), (1, 256, 2, 64, 64)]


def _mlstm_precision(lib, case):
    b, length, h, hd, chunk = case
    ins = MR.grad_inputs(b, length, h, hd, gates="slow",
                         dtype=torch.bfloat16, seed=length + hd)[:5]
    err, out, (c, _, _) = MO.call(lib, *ins, None, chunk, None)
    assert err == 0
    return MR.precision(out, c, *ins, chunk)


@pytest.mark.parametrize("case", MLSTM_PRECISION)
def test_emulated_mlstm_keeps_f32_precision(libs, case):
    """S, the C entering each chunk and wexp o V in three bf16 parts: h
    and C as close to float64 as the plain version's, within
    ref.precision's factors."""
    row = _mlstm_precision(libs["mlstm"], case)
    assert row["ok"], row


def test_emulated_mlstm_precision_catches_two_parts(libs):
    """mlstm.cu with its f32 operands in two bf16 parts
    (ref.FWD_PARTS_FAULT: the kernel as it was) fails every precision
    case."""
    old, new = MR.FWD_PARTS_FAULT
    source = MO._SOURCE.read_text()
    assert source.count(old) == 1
    lib = build(source.replace(old, new), MO._SOURCE.parent, libs["out"],
                "mlstm_parts", MO._SIG)
    for case in MLSTM_PRECISION:
        row = _mlstm_precision(lib, case)
        assert not row["ok"], (case, row)


# mamba_scan: the card tests' gate kinds (SCAN_GATES) and tolerances
# (SCAN_TOL).
SCAN_GATES = {"jax": (0.0, 1.0), "slow": (-4.6, 0.1)}
SCAN_TOL = {torch.float32: {"y": (5e-4, 1e-3), "state": (5e-5, 1e-3)},
            torch.bfloat16: {"y": (2e-2, 2e-2), "state": (5e-5, 1e-3)}}


def _scan_ok(lib, case, common=False):
    """Whether y and the final state pass SCAN_TOL; with ``common`` b has
    a large common part (32 + N(0, 0.5)) that C S^T cancels (c's mean
    over N taken out), so a rounding of S as an operand shows in y."""
    b, length, h, p, n, chunk, gates, dtype = case
    gen = torch.Generator().manual_seed(length + h)
    x = (torch.randn((b, length, h, p), generator=gen) * 0.5).to(dtype)
    mean, std = SCAN_GATES[gates]
    dt = torch.nn.functional.softplus(
        torch.randn((b, length, h), generator=gen) * std + mean)
    a = -torch.exp(torch.randn((h,), generator=gen) * 0.3)
    bb, cc = (torch.randn((b, length, n), generator=gen) * 0.5
              for _ in range(2))
    if common:
        bb, cc = bb + 32.0, cc - cc.mean(-1, keepdim=True)
    ins = (x, dt, a, bb.to(dtype), cc.to(dtype))
    err, y, s = SO.call(lib, *ins, min(chunk, length), None)
    assert err == 0
    yr, sr = SR.ssd_chunked(*ins, chunk)
    tol = SCAN_TOL[dtype]
    return {"y": torch.allclose(y.float(), yr.float(), atol=tol["y"][0],
                                rtol=tol["y"][1]),
            "state": torch.allclose(s, sr, atol=tol["state"][0],
                                    rtol=tol["state"][1])}


SCAN_CASES = [  # (B, L, H, P, N, chunk, gates, dtype)
    (1, 256, 2, 64, 64, 64, "slow", torch.bfloat16),
    (2, 128, 3, 32, 16, 32, "jax", torch.bfloat16),
    (1, 64, 2, 24, 16, 32, "slow", torch.bfloat16),
    (1, 40, 2, 130, 8, 40, "slow", torch.bfloat16),     # 3 P slabs
    (1, 96, 1, 20, 12, 32, "slow", torch.bfloat16),     # element loads
    (1, 128, 2, 24, 16, 64, "slow", torch.float32)]
SCAN_COMMON = (1, 256, 2, 64, 64, 64, "slow", torch.bfloat16)


@pytest.mark.parametrize("case", SCAN_CASES)
def test_emulated_mamba_scan_matches_plain(libs, case):
    ok = _scan_ok(libs["scan"], case)
    assert all(ok.values()), ok


def test_emulated_mamba_scan_keeps_state_precision(libs):
    """bf16, a state with a large common part: C S^T from S's three bf16
    parts passes."""
    ok = _scan_ok(libs["scan"], SCAN_COMMON, common=True)
    assert all(ok.values()), ok


def test_emulated_mamba_scan_checks_catch_state_rounded_once(libs):
    """mamba_scan.cu with only the product of S's first part fails the
    case."""
    old, new = SCAN_ROUND_FAULT
    source = SO._SOURCE.read_text()
    assert source.count(old) == 1
    lib = build(source.replace(old, new), SO._SOURCE.parent, libs["out"],
                "scan_fault", SO._SIG)
    assert not all(_scan_ok(lib, SCAN_COMMON, common=True).values())


# mamba_scan's backward against autograd of the plain version
# (ref.ssd_chunked_grads).  Each gradient's absolute tolerance scales with
# its largest magnitude (f32 sums over up to 64 x H terms in another
# order); bf16 adds one rounding of dx, db and dc.
SCAN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SCAN_BWD_NAMES = ("dx", "ddt", "da", "db", "dc")


def _scan_bwd_ok(lib, case, inputs="random"):
    """Whether each gradient of the emulated backward passes
    SCAN_BWD_TOL, the slow-gate carry share, and the gradients."""
    b, length, h, p, n, chunk, gates, dtype, with_ds = case
    x, dt, a, bb, cc, dy = SR.scan_inputs(b, length, h, p, n, gates=gates,
                                          inputs=inputs, dtype=dtype,
                                          seed=length + h)
    ds = (torch.randn((b, h, p, n), generator=torch.Generator()
                      .manual_seed(5)) if with_ds else None)
    q = min(chunk, length)
    err, got = SO.call_bwd(lib, x, dt, a, bb, cc, dy, ds, q, None)
    assert err == 0
    ref = SR.ssd_chunked_grads(x, dt, a, bb, cc, chunk, dy, ds)
    tol = SCAN_BWD_TOL[dtype]
    ok = {name: torch.allclose(g.float(), r.float(), rtol=tol,
                               atol=tol * max(1.0, r.abs().max().item()))
          for name, g, r in zip(SCAN_BWD_NAMES, got, ref)}
    _, s = SR.ssd_chunked(x, dt, a, bb, cc, chunk)
    return ok, SR.carry_share(x, dt, a, bb, cc, chunk, s), got


SCAN_BWD_CASES = [  # (B, L, H, P, N, chunk, gates, dtype, d s_fin)
    (1, 256, 2, 64, 64, 64, "slow", torch.float32, False),
    (2, 128, 3, 32, 16, 32, "slow", torch.float32, True),
    (2, 128, 3, 32, 16, 32, "model", torch.float32, False),
    (1, 40, 2, 24, 12, 40, "slow", torch.float32, True),     # one chunk
    (1, 192, 2, 64, 64, 64, "slow", torch.bfloat16, True),
    (2, 96, 2, 20, 12, 32, "slow", torch.bfloat16, False),   # ragged tiles
    (1, 128, 2, 32, 16, 64, "model", torch.bfloat16, False)]


@pytest.mark.parametrize("case", SCAN_BWD_CASES)
def test_emulated_mamba_scan_bwd_matches_autograd_of_plain(libs, case):
    ok, share, _ = _scan_bwd_ok(libs["scan_bwd"], case)
    assert all(ok.values()), ok
    if case[6] == "slow" and case[1] > case[5]:
        assert share > 0.1, share      # the state carries across chunks


def _scan_bwd_fault_lib(libs, fault, name):
    old, new = fault
    source = SO._BWD_SOURCE.read_text()
    assert source.count(old) == 1
    return build(source.replace(old, new), SO._SOURCE.parent, libs["out"],
                 name, SO._BWD_SIG)


def test_emulated_mamba_scan_bwd_checks_catch_a_dropped_carry(libs):
    """mamba_scan_bwd.cu without the carry of dS into the chunk before
    (ref.BWD_CARRY_FAULT, both routes' carry_back) fails the slow-gate
    cases of several chunks, in both dtypes."""
    lib = _scan_bwd_fault_lib(libs, SR.BWD_CARRY_FAULT, "scan_bwd_fault")
    for case in (SCAN_BWD_CASES[0], SCAN_BWD_CASES[4]):
        ok, _, _ = _scan_bwd_ok(lib, case)
        assert not all(ok.values()), (case, ok)


# mlstm's backward against autograd of the plain version
# (ref.mlstm_chunked_grads), from the zero state.  Each gradient's
# absolute tolerance scales with its largest magnitude (f32 sums over up
# to hd or the chunk in another order); bf16 adds one rounding of dq, dk
# and dv.
MLSTM_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
MLSTM_BWD_NAMES = ("dq", "dk", "dv", "dlogi", "dlogf")


def _mlstm_bwd_ok(lib, case):
    """Whether each gradient of the emulated backward passes
    MLSTM_BWD_TOL, the floor's share of the rows, and the gradients."""
    b, length, h, hd, chunk, gates, inputs, dtype = case
    q, k, v, li, lf, dh = MR.grad_inputs(b, length, h, hd, gates=gates,
                                         inputs=inputs, dtype=dtype,
                                         seed=length + hd)
    binds = torch.empty((b, h, length))
    err, got = MO.call_bwd(lib, q, k, v, li, lf, dh, min(chunk, length),
                           None, binds)
    assert err == 0
    ref = MR.mlstm_chunked_grads(q, k, v, li, lf, chunk, dh)
    tol = MLSTM_BWD_TOL[dtype]
    ok = {name: torch.allclose(g.float(), r.float(), rtol=tol,
                               atol=tol * max(1.0, r.abs().max().item()))
          for name, g, r in zip(MLSTM_BWD_NAMES, got, ref)}
    share = MR.floor_share(q, k, v, li, lf, chunk)
    assert abs(binds.mean().item() - share) < 0.02, (binds.mean(), share)
    return ok, share, got


MLSTM_BWD_CASES = [  # (B, L, H, hd, chunk, gates, inputs, dtype)
    (1, 96, 2, 32, 32, "slow", "random", torch.float32),
    (2, 100, 2, 48, 32, "slow", "random", torch.float32),   # ragged tail
    (1, 100, 1, 64, 32, "slow", "floor", torch.float32),
    (1, 64, 2, 16, 16, "jax", "random", torch.float32),
    (1, 37, 2, 8, 16, "model", "random", torch.float32),
    (1, 100, 2, 48, 32, "slow", "random", torch.bfloat16),
    (1, 72, 1, 64, 32, "slow", "floor", torch.bfloat16),
    (1, 130, 1, 20, 128, "slow", "random", torch.bfloat16)]  # 2 C tiles


@pytest.mark.parametrize("case", MLSTM_BWD_CASES)
def test_emulated_mlstm_bwd_matches_autograd_of_plain(libs, case):
    ok, share, _ = _mlstm_bwd_ok(libs["mlstm_bwd"], case)
    assert all(ok.values()), ok
    if case[6] == "floor":
        assert share > 0.5, share      # the floor binds on most rows


def _mlstm_bwd_fault_lib(libs, fault, name):
    old, new = fault
    source = MO._BWD_SOURCE.read_text()
    assert source.count(old) == 1
    return build(source.replace(old, new), MO._SOURCE.parent, libs["out"],
                 name, MO._BWD_SIG)


@pytest.mark.parametrize("fault,cases", [
    ("carry", (MLSTM_BWD_CASES[0], MLSTM_BWD_CASES[5])),
    ("floor", (MLSTM_BWD_CASES[2], MLSTM_BWD_CASES[6]))])
def test_emulated_mlstm_bwd_checks_catch_planted_faults(libs, fault, cases):
    """mlstm_bwd.cu without the carry of (dC, dn) into the chunk before
    (ref.BWD_CARRY_FAULT) fails the slow-gate cases of several chunks;
    with the floor's branch ignored (ref.BWD_FLOOR_FAULT) it fails the
    cases whose floor binds on most rows; both dtypes."""
    lib = _mlstm_bwd_fault_lib(libs, {"carry": MR.BWD_CARRY_FAULT,
                                      "floor": MR.BWD_FLOOR_FAULT}[fault],
                               f"mlstm_bwd_{fault}")
    for case in cases:
        ok, _, _ = _mlstm_bwd_ok(lib, case)
        assert not all(ok.values()), (case, ok)
