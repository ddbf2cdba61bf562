"""The hand-written CUDA kernels against their plain PyTorch versions, on
a GPU.  Marked ``cuda``: they skip on a machine without one.  This file
imports neither JAX nor ``repro``, so it also runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
from unittest import mock

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as TO
from repro_torch.kernels.flash_attention import ref as TR
from repro_torch.kernels.mamba_scan import ref as SR


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,window,hd", [(1, 128, 0, 64), (1, 1000, 0, 64),
                                           (1, 1024, 256, 64), (1, 300, 0, 80),
                                           (4, 512, 0, 64), (1, 1024, 0, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(cuda_device, b, s, window, hd, dtype):
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(s)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((b, s, n, hd), generator=gen,
                           device=cuda_device).to(dt) for n in (32, 8, 8))
    before = TO.launches
    out = TO.flash_attention(q, k, v, causal=True, window=window)
    assert TO.launches == before + 1
    ref = TR.attention_ref(*(x.transpose(1, 2) for x in (q, k, v)),
                           causal=True, window=window).transpose(1, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(1, 1024), (4, 512), (1, 1000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_group_one_matches_plain(cuda_device, b, s, dtype):
    """Group 1: as many KV heads as query heads, at whisper-small's
    decoder (H 12 = KV 12, hd 64): a 1024-token prefill, the 4 x 512
    fixed batch and a ragged length; forward and backward."""
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(s + b)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((b, s, 12, 64), generator=gen,
                           device=cuda_device).to(dt).requires_grad_()
               for _ in range(3))
    dout = torch.randn((b, s, 12, 64), generator=gen,
                       device=cuda_device).to(dt)
    before = (TO.launches, TO.bwd_launches)
    out = TO.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert (TO.launches, TO.bwd_launches) == (before[0] + 1, before[1] + 1)
    ref = TR.attention_ref(*(x.transpose(1, 2) for x in (q, k, v)),
                           causal=True).transpose(1, 2)
    rgrads = torch.autograd.grad(ref, (q, k, v), dout)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    btol = BWD_TOL[dtype]
    for g, r in zip(grads, rgrads):
        torch.testing.assert_close(g.float(), r.float(), atol=btol,
                                   rtol=btol)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros((1, 4, 128, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        TO._launch(q, q[:, :2].contiguous(), q[:, :2].contiguous(),
                   causal=True, window=0, scale=0.125)
    q = torch.zeros((1, 4, 128, 96), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        TO._launch(q, q[:, :2].contiguous(), q[:, :2].contiguous(),
                   causal=True, window=0, scale=0.125)
    q = torch.zeros((1, 128, 4, 64), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        TO._launch(q, q[:, :2], q[:, :2], causal=True, window=0, scale=0.125)


# Backward tolerances: f32 accumulation order over up to S * G terms
# (f32), and the bf16 rounding of O (in D = rowsum(dO * O)) and of the
# outputs (bf16).
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,window,hd", [(2, 1024, 0, 64), (1, 1000, 0, 64),
                                           (1, 1024, 256, 64), (1, 300, 0, 80),
                                           (4, 512, 0, 64), (1, 1024, 0, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_matches_autograd_of_plain(cuda_device, b, s, window,
                                                 hd, dtype):
    tol = BWD_TOL[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(s + window)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=cuda_device)
               .to(dt).requires_grad_() for n in (32, 8, 8))
    dout = torch.randn((b, s, 32, hd), generator=gen,
                       device=cuda_device).to(dt)
    before = (TO.launches, TO.bwd_launches)
    out = TO.flash_attention(q, k, v, causal=True, window=window)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert (TO.launches, TO.bwd_launches) == (before[0] + 1, before[1] + 1)
    ref = TR.attention_ref(*(x.transpose(1, 2) for x in (q, k, v)),
                           causal=True, window=window).transpose(1, 2)
    rgrads = torch.autograd.grad(ref, (q, k, v), dout)
    torch.cuda.synchronize()
    for g, r in zip(grads, rgrads):
        assert g.dtype == dt and g.shape == r.shape
        assert bool(torch.isfinite(g.float()).all())
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol)


# (H, KV, hd, B, S) of the training paths' flash shapes: whisper-small's
# group 1 (a rank's 2 x 448), granite-moe-1b-a400m's group 2 (4 x 1024)
# and llama-3.2-vision-11b's group 4 at hd 128 (2 x 1024); and groups 3
# and 16 at hd 128 (24 / 8 and 32 / 2 heads)
GROUP_CASES = [(12, 12, 64, 2, 448), (16, 8, 64, 4, 1024),
               (32, 8, 128, 2, 1024), (24, 8, 128, 1, 1024),
               (32, 2, 128, 1, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv,hd,b,s", GROUP_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_groups_match_plain(cuda_device, h, kv, hd, b, s, dtype):
    """Forward and backward at the head groups the trained families run
    (and groups 3 and 16), against the plain version and its autograd."""
    gen = torch.Generator(device=cuda_device).manual_seed(h * kv + s)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=cuda_device)
               .to(dt).requires_grad_() for n in (h, kv, kv))
    dout = torch.randn((b, s, h, hd), generator=gen,
                       device=cuda_device).to(dt)
    before = (TO.launches, TO.bwd_launches)
    out = TO.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert (TO.launches, TO.bwd_launches) == (before[0] + 1, before[1] + 1)
    ref = TR.attention_ref(*(x.transpose(1, 2) for x in (q, k, v)),
                           causal=True).transpose(1, 2)
    rgrads = torch.autograd.grad(ref, (q, k, v), dout)
    torch.cuda.synchronize()
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    btol = BWD_TOL[dtype]
    for g, r in zip(grads, rgrads):
        assert bool(torch.isfinite(g.float()).all())
        torch.testing.assert_close(g.float(), r.float(), atol=btol,
                                   rtol=btol)


def _rising_inputs(b, s, hd, dtype, device, seed):
    """q, k, v (B, S, H, hd) with H 32, KV 8 whose keys grow with their
    position, so that each row's running maximum rises from one key tile
    to the next: a kernel that drops the online softmax's rescale of its
    accumulator and sum gives wrong rows."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn((b, s, 32, hd), generator=gen, device=device).abs()
    k = torch.randn((b, s, 8, hd), generator=gen, device=device).abs()
    k = k * (1 + torch.arange(s, device=device)[None, :, None, None] / 128)
    v = torch.randn((b, s, 8, hd), generator=gen, device=device)
    return tuple(x.to(dt) for x in (q, k, v))


def _tile_max_rises(q, k, tile=64):
    """Share of query rows whose largest logit over the keys of their last
    visible tile exceeds that over their first tile (causal)."""
    qt, kt = q.float().transpose(1, 2), k.float().transpose(1, 2)
    g = qt.shape[1] // kt.shape[1]
    logits = qt @ kt.repeat_interleave(g, 1).transpose(-1, -2)
    s = q.shape[1]
    rows = torch.arange(tile, s, device=q.device)
    first = logits[..., rows, :tile].amax(-1)
    last = torch.stack([logits[..., r, (r // tile) * tile:r + 1].amax(-1)
                        for r in rows.tolist()], -1)
    return float((last > first).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_rising_row_max(cuda_device, hd, dtype):
    """Forward and backward where every row's maximum rises across key
    tiles, against the plain version and autograd of it."""
    q, k, v = _rising_inputs(1, 1024, hd, dtype, cuda_device, hd)
    assert _tile_max_rises(q, k) > 0.9
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    out = TO.flash_attention(q, k, v, causal=True)
    ref = TR.attention_ref(*(x.transpose(1, 2) for x in (q, k, v)),
                           causal=True).transpose(1, 2)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    dout = torch.randn(out.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(5), device=cuda_device).to(q.dtype)
    grads = torch.autograd.grad(TO.flash_attention(*leaves), leaves, dout)
    rref = TR.attention_ref(*(x.transpose(1, 2) for x in leaves),
                            causal=True).transpose(1, 2)
    rgrads = torch.autograd.grad(rref, leaves, dout)
    torch.cuda.synchronize()
    for g, r in zip(grads, rgrads):
        torch.testing.assert_close(g.float(), r.float(), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype])


# A fault planted in a copy of csrc/flash_attention.cu (built into a
# temporary directory, never into the repository): the bf16 kernel's
# rescale of its running sum and accumulator when a row's maximum rises.
FLASH_FAULT = TR.FWD_RESCALE_FAULT


@pytest.mark.cuda
def test_cuda_flash_checks_catch_a_missing_rescale(cuda_device, tmp_path,
                                                   monkeypatch):
    import ctypes
    import json

    from repro_torch.kernels import _build
    old, new = FLASH_FAULT
    source = (TO._CSRC / "flash_attention.cu").read_text()
    assert source.count(old) == 1
    mutant = tmp_path / "flash_attention.cu"
    mutant.write_text(source.replace(old, new))
    so = tmp_path / "libflash_fault.so"
    _build.compile_to("flash_fault", mutant, so)
    lib = _build.bind(ctypes.CDLL(str(so)), TO._FWD_SIG)
    monkeypatch.setattr(TO, "fwd_lib", lambda: lib)
    caught = {}
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for name, hd in (("randn", 64), ("randn", 128), ("rising", 64),
                     ("rising", 128)):
        if name == "rising":
            q, k, v = _rising_inputs(1, 1024, hd, "bfloat16", cuda_device, hd)
        else:
            q, k, v = (torch.randn((1, 1024, n, hd), generator=gen,
                                   device=cuda_device).bfloat16()
                       for n in (32, 8, 8))
        out = TO.flash_attention(q, k, v, causal=True)
        ref = TR.attention_ref(*(x.transpose(1, 2) for x in (q, k, v)),
                               causal=True).transpose(1, 2)
        err = (out.float() - ref.float()).abs().max().item()
        caught[(name, hd)] = not torch.allclose(out.float(), ref.float(),
                                                atol=2e-2, rtol=2e-2)
        row = {"inputs": name, "hd": hd, "max_abs_err": err}
        print(f"flash-fault {json.dumps(row)}", flush=True)
    assert all(caught.values()), caught


@pytest.mark.cuda
def test_cuda_backward_is_deterministic(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn((2, 1024, n, 64), generator=gen,
                           device=cuda_device).bfloat16().requires_grad_()
               for n in (32, 8, 8))
    dout = torch.randn((2, 1024, 32, 64), generator=gen,
                       device=cuda_device).bfloat16()
    first = torch.autograd.grad(TO.flash_attention(q, k, v), (q, k, v), dout)
    second = torch.autograd.grad(TO.flash_attention(q, k, v), (q, k, v), dout)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_cuda_attention_layer_gives_qkv_weights_gradients(cuda_device):
    """A backward pass through an attention layer on the card reaches wq,
    wk and wv (the forward kernel alone has no grad_fn)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import attention as attn
    cfg = get_config("llama3.2-1b").with_(dtype="float32")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = attn.init_attention(gen, cfg, device=cuda_device)
    params = {n: w.requires_grad_() for n, w in params.items()}
    x = torch.randn((1, 256, cfg.d_model), generator=gen, device=cuda_device)
    pos = torch.arange(256, device=cuda_device)[None]
    before = TO.bwd_launches
    out, _ = attn.attention(params, x, cfg, pos)
    grads = torch.autograd.grad(out.square().sum(), list(params.values()))
    assert TO.bwd_launches == before + 1
    with mock.patch.object(attn, "causal_attention",
                           attn.plain_causal_attention):
        rout, _ = attn.attention(params, x, cfg, pos)
        rgrads = torch.autograd.grad(rout.square().sum(),
                                     list(params.values()))
    for name, g, r in zip(params, grads, rgrads):
        assert float(g.abs().max()) > 0, name
        assert float((g - r).norm() / r.norm()) < 1e-4, name


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", [(8, 16), (24, 33), (16, 1), (1, 64),
                                 (100_000, 20), (3, 5000)])
def test_cuda_codec_bit_exact_to_plain(cuda_device, k, m):
    from repro_torch.kernels.collective_codec import ops as CO
    from repro_torch.kernels.collective_codec import ref as CR
    gen = torch.Generator(device=cuda_device).manual_seed(k + m)
    x = torch.randn((k, m), generator=gen, device=cuda_device)
    x[0, :] = torch.round(x[0, :])          # ties in the first row
    if k > 1:
        x[1, m // 2] = float("nan")         # a NaN row
    before = CO.launches
    vals, col, resid = CO.chunk_select(x)
    assert CO.launches == before + 1
    rv, rc, rr = CR.chunk_select_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(col, rc) and col.dtype == torch.int32
    assert torch.equal(vals, rv)
    assert torch.equal(torch.nan_to_num(resid, 7.0),
                       torch.nan_to_num(rr, 7.0))


@pytest.mark.cuda
def test_cuda_codec_shards_and_compressed_sync(cuda_device):
    from repro_torch.core import collectives as C
    from repro_torch.kernels.collective_codec import ops as CO
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    trees = [{"w": torch.randn((64, 33), generator=gen, device=cuda_device),
              "b": torch.randn((71,), generator=gen, device=cuda_device)}
             for _ in range(4)]
    cpu = [{n: t.cpu() for n, t in tr.items()} for tr in trees]
    for frac in (0.05, 1.0):
        before = CO.launches
        resid = C.init_residual_buffer(trees[0], 2, 2)
        out, new = C.tree_sync(trees, "compressed", 2, 2, frac, resid)
        assert CO.launches == before + 1            # one launch, 4 shards
        cresid = C.init_residual_buffer(cpu[0], 2, 2)
        cout, cnew = C.tree_sync(cpu, "compressed", 2, 2, frac, cresid)
        assert torch.equal(new.cpu(), cnew)
        for n in out:
            torch.testing.assert_close(out[n].cpu(), cout[n], atol=0, rtol=0)
    hier, _ = C.tree_sync(trees, "hierarchical", 2, 2)
    comp, _ = C.tree_sync(trees, "compressed", 2, 2, 1.0,
                          C.init_residual_buffer(trees[0], 2, 2))
    for n in hier:
        assert torch.equal(hier[n], comp[n])


@pytest.mark.cuda
def test_cuda_matmul_f32out_has_no_f32_copy_and_a_gradient(cuda_device):
    from repro_torch.models.layers import matmul_f32out
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn((2, 16, 256), generator=gen,
                    device=cuda_device).bfloat16().requires_grad_()
    w = torch.randn((512, 256), generator=gen,
                    device=cuda_device).bfloat16().requires_grad_()
    out = matmul_f32out(x, w.t())
    assert out.dtype == torch.float32
    ref = torch.matmul(x.float(), w.float().t())
    torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-3)
    gx, gw = torch.autograd.grad(out.sum(), (x, w))
    rx, rw = torch.autograd.grad(ref.sum(), (x, w))
    assert gx.dtype == gw.dtype == torch.bfloat16
    torch.testing.assert_close(gx.float(), rx.float(), atol=0.1, rtol=2e-2)
    torch.testing.assert_close(gw.float(), rw.float(), atol=0.1, rtol=2e-2)


def _dm_inputs(shape, dtype, op, device, seed):
    """a0, b0 and b1 = b0 with a few chunks changed (plus NaN and -0
    chunks for floats)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    if dt.is_floating_point:
        a0, b0 = ((torch.randn(shape, generator=gen, device=device) + 2.0)
                  .to(dt) for _ in range(2))
    else:
        lo = 1 if op in ("multiply", "divide") else -2 ** 20
        a0, b0 = (torch.randint(lo, 2 ** 20, shape, generator=gen,
                                device=device, dtype=dt) for _ in range(2))
    b1 = b0.clone()
    flat = b1.view(-1)
    flat[::97] *= 3
    flat[5:40] += 7
    if dt.is_floating_point and flat.numel() > 3 * 1024:
        b0.view(-1)[2048 + 9] = float("nan")    # NaN in both: dirty
        flat[2048 + 9] = float("nan")
        flat[1024:2048] = b0.view(-1)[1024:2048]
        b0.view(-1)[1024 + 7] = 0.0
        flat[1024 + 7] = -0.0                     # -0 vs +0: clean
    return a0, b0, b1


def _dm_bits_equal(x, y):
    """Bit for bit where not NaN; NaN where NaN (payloads aside)."""
    if not x.dtype.is_floating_point:
        return torch.equal(x, y)
    nan = torch.isnan(x)
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    return torch.equal(nan, torch.isnan(y)) and torch.equal(
        x.view(view)[~nan], y.view(view)[~nan])


DM_CASES = [(op, dt) for op in ("sum", "subtract", "multiply", "divide",
                                "overwrite")
            for dt in ("bfloat16", "float32", "float64", "float16", "int32")]
DM_CASES += [(op, "int64") for op in ("sum", "subtract", "overwrite")]


@pytest.mark.cuda
@pytest.mark.parametrize("op,dtype", DM_CASES)
@pytest.mark.parametrize("shape", [(32, 1024), (13, 77), (3333,)])
def test_cuda_diff_merge_bit_exact_to_plain(cuda_device, op, dtype, shape):
    from repro_torch.kernels.diff_merge import ops as DO
    from repro_torch.kernels.diff_merge import ref as DR
    a0, b0, b1 = _dm_inputs(shape, dtype, op, cuda_device, len(op))
    before = DO.launches
    out, dirty = DO.diff_merge_leaf(a0, b0, b1, op=op)
    assert DO.launches == before + 1
    rout, rdirty = DR.diff_merge_leaf_ref(a0, b0, b1, op=op)
    torch.cuda.synchronize()
    assert out.shape == a0.shape and out.dtype == a0.dtype
    assert torch.equal(dirty, rdirty) and bool(dirty.any())
    assert _dm_bits_equal(out, rout)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
def test_cuda_diff_merge_unaligned_views(cuda_device, dtype):
    """Views that start one element in take the kernel's scalar loads."""
    from repro_torch.kernels.diff_merge import ops as DO
    from repro_torch.kernels.diff_merge import ref as DR
    a0, b0, b1 = (x.view(-1)[1:5001] for x in
                  _dm_inputs((5002,), dtype, "sum", cuda_device, 9))
    out, dirty = DO.diff_merge_leaf(a0, b0, b1, op="sum")
    rout, rdirty = DR.diff_merge_leaf_ref(a0, b0, b1, op="sum")
    torch.cuda.synchronize()
    assert torch.equal(dirty, rdirty) and _dm_bits_equal(out, rout)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["multiply", "divide"])
def test_cuda_diff_merge_int32_clean_chunks_round(cuda_device, op):
    from repro_torch.kernels.diff_merge import ops as DO
    a0 = torch.full((2, 1024), 2 ** 24 + 1, dtype=torch.int32,
                    device=cuda_device)
    b0 = torch.full_like(a0, 4)
    b1 = b0.clone()
    b1[1, 0] = 8
    b1[1, 1] = 2 ** 30                    # saturates under multiply
    out, dirty = DO.diff_merge_leaf(a0, b0, b1, op=op)
    assert dirty.tolist() == [False, True]
    assert bool((out[0] == 2 ** 24).all())   # clean, yet rounded in f32
    if op == "multiply":
        assert out[1, 1].item() == 2 ** 31 - 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_diff_of_a_live_leaf_matches_the_host_diff(cuda_device, dtype):
    """A fabric checkpoint diffs a gang's live CUDA leaves against the
    last host checkpoint: the diff_merge kernel finds the dirty chunks on
    the card, and the LeafDiff (indices, rows, the ragged tail) equals
    the host diff's, so the chain replays bit for bit."""
    from repro_torch.core import diffsync as DS
    from repro_torch.kernels.diff_merge import ops as DO
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    n = DS.KERNEL_MIN_ELEMS + 777            # a ragged tail
    dt = getattr(torch, dtype)
    live = {"w": torch.randn(n, generator=gen, device=cuda_device).to(dt),
            "b": torch.randn((5, 3), generator=gen,
                             device=cuda_device).to(dt)}
    old = {k: v.cpu() for k, v in live.items()}
    live["w"][5 * 1024 + 3] += 1.0
    live["w"][7 * 1024:9 * 1024] += 1.0
    live["w"][-5] += 1.0                     # the tail chunk
    live["b"][0, 0] += 1.0
    before = DO.launches
    got = DS.diff_tree(old, live)
    assert DO.launches == before + 1         # the big leaf only
    want = DS.diff_tree(old, {k: v.cpu() for k, v in live.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k].idx, want[k].idx)
        assert torch.equal(got[k].new, want[k].new)
        assert torch.equal(got[k].old, want[k].old)
    assert got["['w']"].idx.tolist() == [5, 7, 8, n // 1024]
    merged = DS.apply_tree(old, got)
    for k in live:
        assert torch.equal(merged[k], live[k].cpu())


@pytest.mark.cuda
def test_cuda_fused_diff_apply_sends_large_leaves_to_the_kernel(cuda_device):
    from repro_torch.core import diffsync as DS
    from repro_torch.kernels.diff_merge import ops as DO
    big = _dm_inputs((DS.KERNEL_MIN_ELEMS,), "float32", "sum", cuda_device, 1)
    small = _dm_inputs((3000,), "float32", "sum", cuda_device, 2)
    before = DO.launches
    merged, dirty = DS.fused_diff_apply(*big, op="overwrite")
    assert DO.launches == before + 1 and merged.is_cuda
    assert torch.equal(merged, big[2]) or bool(torch.isnan(big[2]).any())
    host, hdirty = DS.fused_diff_apply(*small, op="sum")
    assert DO.launches == before + 1      # small: the host path
    assert host.is_cuda and hdirty.is_cuda
    want, wdirty = DS.fused_diff_apply(*(x.cpu() for x in small), op="sum",
                                       use_kernel=False)
    assert torch.equal(host.cpu(), want) and torch.equal(hdirty.cpu(), wdirty)


# ---------------------------------------------------------------------------
# moe_gmm and mamba_scan (slice 4).  Tolerances: f32 sums in another order
# (moe_gmm over d and ff, mamba_scan over N and the chunk; the mamba ones
# are the JAX kernel tests' own); bf16 adds one rounding of the output.
# ---------------------------------------------------------------------------
GMM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SCAN_TOL = {"float32": {"y": (5e-4, 1e-3), "state": (5e-5, 1e-3)},
            "bfloat16": {"y": (2e-2, 2e-2), "state": (5e-5, 1e-3)}}


def _gmm_inputs(e, m, d, ff, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    x = (torch.randn((e, m, d), generator=gen, device=device) * 0.5).to(dt)
    w1, w3 = ((torch.randn((e, d, ff), generator=gen, device=device)
               * 0.05).to(dt) for _ in range(2))
    w2 = (torch.randn((e, ff, d), generator=gen, device=device)
          * 0.05).to(dt)
    return x, w1, w2, w3


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,d,ff,act", [
    (32, 320, 1024, 512, "silu"), (32, 8, 1024, 512, "silu"),
    (32, 100, 1024, 512, "silu"), (32, 8, 1024, 512, "gelu"),
    (4, 256, 64, 256, "silu"), (2, 128, 128, 512, "gelu"),
    (8, 64, 32, 128, "silu"), (2, 40, 130, 96, "gelu"),
    (3, 33, 1000, 200, "silu"),
    # phi3.5-moe: a 1024-token prefill (2 groups x capacity 80), 8-lane
    # decode (capacity top_k), and a ragged last slab of y's columns
    (16, 160, 4096, 6400, "silu"), (16, 2, 4096, 6400, "silu"),
    (2, 40, 1100, 96, "silu"), (2, 33, 1100, 70, "gelu"),
    # the bf16 route's tile edges: M 16 / 17 (decode / prefill tiles),
    # a ragged ff-tile and d-tile, one row
    (3, 16, 136, 200, "silu"), (2, 17, 1024, 512, "silu"),
    (4, 1, 72, 64, "gelu")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_moe_gmm_matches_plain(cuda_device, e, m, d, ff, act, dtype):
    from repro_torch.kernels.moe_gmm import ops as GO
    from repro_torch.kernels.moe_gmm import ref as GR
    x, w1, w2, w3 = _gmm_inputs(e, m, d, ff, dtype, cuda_device, m + d)
    before = GO.launches
    out = GO.expert_ffn_kernel_layout(x, w1, w2, w3, act=act)
    assert GO.launches == before + 1
    ref = GR.expert_ffn_ref(x, w1, w2, w3, act=act)
    torch.cuda.synchronize()
    tol = GMM_TOL[dtype]
    assert out.dtype == x.dtype and out.shape == (e, m, d)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


# Inputs whose h has a large part common to each row (ref.
# common_part_inputs): granite's and phi3.5-moe's prefill and decode
# shapes and a small one.  h rounded once to bf16 fails them.
GMM_COMMON = [(32, 320, 1024, 512), (32, 8, 1024, 512),
              (16, 160, 4096, 6400), (16, 2, 4096, 6400), (2, 24, 64, 128)]


def _gmm_common_errors(GO, GR, e, m, d, ff, device):
    """(max abs error, passes GMM_TOL, passes chip_smoke's tolerance
    scaled by the output's largest magnitude) on a common-part case."""
    ins = GR.common_part_inputs(e, m, d, ff, dtype=torch.bfloat16,
                                device=device, seed=m)
    out = GO.expert_ffn_kernel_layout(*ins).float()
    ref = GR.expert_ffn_ref(*ins).float()
    tol = GMM_TOL["bfloat16"]
    scale = max(1.0, ref.abs().max().item())
    return ((out - ref).abs().max().item(),
            torch.allclose(out, ref, atol=tol, rtol=tol),
            torch.allclose(out, ref, atol=tol * scale, rtol=tol))


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,d,ff", GMM_COMMON)
def test_cuda_moe_gmm_keeps_h_precision(cuda_device, e, m, d, ff):
    from repro_torch.kernels.moe_gmm import ops as GO
    from repro_torch.kernels.moe_gmm import ref as GR
    err, ok, ok_scaled = _gmm_common_errors(GO, GR, e, m, d, ff,
                                            cuda_device)
    assert ok and ok_scaled, err


@pytest.mark.cuda
def test_cuda_moe_gmm_checks_catch_h_rounded_once(cuda_device, tmp_path,
                                                  monkeypatch):
    """A copy of moe_gmm.cu without the h_lo product (h rounded once to
    bf16 before h w2) fails every common-part case, at GMM_TOL and at
    chip_smoke's scaled tolerance."""
    import ctypes
    import json

    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_gmm import ops as GO
    from repro_torch.kernels.moe_gmm import ref as GR
    old, new = GR.FWD_ROUND_FAULT
    source = GO._SOURCE.read_text()
    assert source.count(old) == 1
    mutant = tmp_path / "moe_gmm.cu"
    mutant.write_text(source.replace(old, new))
    so = tmp_path / "libmoe_gmm_fault.so"
    _build.compile_to("moe_gmm_fault", mutant, so)
    lib = _build.bind(ctypes.CDLL(str(so)), GO._SIG)
    monkeypatch.setattr(GO, "lib", lambda: lib)
    caught = {}
    for e, m, d, ff in GMM_COMMON:
        err, ok, ok_scaled = _gmm_common_errors(GO, GR, e, m, d, ff,
                                                cuda_device)
        caught[(e, m, d, ff)] = not ok and not ok_scaled
        row = {"E": e, "M": m, "d": d, "ff": ff, "max_abs_err": err,
               "ok": ok, "ok_scaled": ok_scaled}
        print(f"gmm-fault {json.dumps(row)}", flush=True)
    assert all(caught.values()), caught


@pytest.mark.cuda
def test_cuda_moe_gmm_model_layout_and_refusals(cuda_device):
    from repro_torch.kernels.moe_gmm import ops as GO
    from repro_torch.kernels.moe_gmm import ref as GR
    x, w1, w2, w3 = _gmm_inputs(4, 2 * 24, 64, 96, "float32", cuda_device, 3)
    xe = x.reshape(4, 2, 24, 64).transpose(0, 1)          # (G, E, C, d)
    out = GO.expert_ffn(xe, w1, w2, w3)
    ref = GR.expert_ffn_ref(x, w1, w2, w3).reshape(4, 2, 24, 64)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref.transpose(0, 1), atol=1e-4,
                               rtol=1e-4)
    with pytest.raises(TypeError, match="dtype"):
        GO.expert_ffn_kernel_layout(x, w1.bfloat16(), w2, w3)
    # a gradient flows through the kernel: the backward kernel's
    w1g = w1.clone().requires_grad_()
    before = GO.bwd_launches
    (g1,) = torch.autograd.grad(
        GO.expert_ffn_kernel_layout(x, w1g, w2, w3).square().sum(), [w1g])
    assert GO.bwd_launches == before + 1
    ref = w1.clone().requires_grad_()
    (r1,) = torch.autograd.grad(
        GR.expert_ffn_ref(x, ref, w2, w3).square().sum(), [ref])
    torch.testing.assert_close(g1, r1, atol=1e-4, rtol=1e-4)
    # d above one slab of 1024 columns runs (two slabs here)
    x, w1, w2, w3 = _gmm_inputs(1, 8, 2048, 8, "float32", cuda_device, 4)
    out = GO.expert_ffn_kernel_layout(x, w1, w2, w3)
    ref = GR.expert_ffn_ref(x, w1, w2, w3)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


def _gmm_grads(GO, x, w1, w2, w3, dy, act):
    """(dx, dw1, dw2, dw3) through the wrapper's autograd route: one
    forward and one backward call of the kernels, the backward through
    the design ``GO.bwd_design`` names."""
    leaves = [t.clone().requires_grad_() for t in (x, w1, w2, w3)]
    e, m, d = x.shape
    design = GO.bwd_design(e, m, d, w1.shape[-1], x.dtype)
    before = (GO.launches, GO.bwd_launches, GO.bwd_design_launches[design])
    y = GO.expert_ffn_kernel_layout(*leaves, act=act)
    grads = torch.autograd.grad(y, leaves, dy, allow_unused=True)
    assert (GO.launches, GO.bwd_launches,
            GO.bwd_design_launches[design]) == tuple(n + 1 for n in before)
    return grads


def _gmm_grads_ok(got, ref, dtype):
    """Each gradient within GMM_TOL (``ref.grads_close``)."""
    from repro_torch.kernels.moe_gmm import ref as GR
    return GR.grads_close(got, ref, GMM_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,d,ff,act", [
    # granite's training shape (8 groups x capacity 160), a ragged M, gelu
    (32, 1280, 1024, 512, "silu"), (32, 100, 1024, 512, "silu"),
    (4, 256, 64, 256, "gelu"),
    # unaligned d and ff (mma.sync, element loads), ragged tiles (wgmma)
    (2, 33, 130, 70, "gelu"), (3, 40, 1000, 200, "silu"),
    (2, 33, 72, 70, "gelu"), (1, 17, 130, 64, "silu"),
    # phi3.5-moe's prefill shape (ff 6400, d 4096)
    (16, 160, 4096, 6400, "silu")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_moe_gmm_bwd_matches_autograd_of_plain(cuda_device, e, m, d, ff,
                                                    act, dtype):
    from repro_torch.kernels.moe_gmm import ops as GO
    from repro_torch.kernels.moe_gmm import ref as GR
    x, w1, w2, w3 = _gmm_inputs(e, m, d, ff, dtype, cuda_device, m + ff)
    dy = torch.randn((e, m, d), generator=torch.Generator(
        device=cuda_device).manual_seed(m), device=cuda_device).to(x.dtype)
    got = _gmm_grads(GO, x, w1, w2, w3, dy, act)
    ref = GR.expert_ffn_grads_ref(x, w1, w2, w3, dy, act=act)
    torch.cuda.synchronize()
    assert [g.dtype for g in got] == [x.dtype] * 4
    assert all(_gmm_grads_ok(got, ref, dtype)), _gmm_grads_ok(got, ref, dtype)
    if act == "gelu":
        assert not got[3].any()


@pytest.mark.cuda
def test_cuda_moe_gmm_bwd_is_deterministic(cuda_device):
    """The weight gradients are reduced over M in a fixed order, with no
    float atomics: two runs are bit-equal."""
    from repro_torch.kernels.moe_gmm import ops as GO
    x, w1, w2, w3 = _gmm_inputs(32, 1280, 1024, 512, "bfloat16",
                                cuda_device, 5)
    dy = torch.randn_like(x)
    first = GO._launch_bwd(x, w1, w2, w3, dy, "silu")
    second = GO._launch_bwd(x, w1, w2, w3, dy, "silu")
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_cuda_moe_gmm_bwd_takes_mma_sync_off_16_bytes(cuda_device):
    """x 2 bytes off 16-byte alignment (contiguous, so the wrapper takes
    it as it lies) is what TMA cannot describe: the call goes through the
    mma.sync design and agrees with the plain version."""
    from repro_torch.kernels.moe_gmm import ops as GO
    from repro_torch.kernels.moe_gmm import ref as GR
    x, w1, w2, w3 = _gmm_inputs(2, 40, 64, 96, "bfloat16", cuda_device, 9)
    dy = torch.randn_like(x)
    off = torch.empty(x.numel() + 1, dtype=x.dtype,
                      device=cuda_device)[1:].view(x.shape)
    off.copy_(x)
    assert off.data_ptr() % 16 != 0 and off.is_contiguous()
    before = dict(GO.bwd_design_launches)
    got = GO._launch_bwd(off, w1, w2, w3, dy, "silu")
    assert GO.bwd_design_launches["mma.sync"] == before["mma.sync"] + 1
    ref = GR.expert_ffn_grads_ref(x, w1, w2, w3, dy)
    torch.cuda.synchronize()
    assert all(_gmm_grads_ok(got, ref, "bfloat16"))


# The backward's common-part cases (ref.common_part_inputs with
# ref.common_part_grad): granite's training shape, phi3.5-moe's prefill
# shape and a small one.  h rounded once to bf16 in dw2 fails them.
GMM_BWD_COMMON = [(32, 1280, 1024, 512), (16, 160, 4096, 6400),
                  (1, 100, 256, 128)]


def _gmm_bwd_common(GO, GR, e, m, d, ff, device):
    ins = GR.common_part_inputs(e, m, d, ff, dtype=torch.bfloat16,
                                device=device, seed=m)
    dy = GR.common_part_grad(e, m, d, dtype=torch.bfloat16, device=device,
                             seed=m + 1)
    got = _gmm_grads(GO, *ins, dy, "silu")
    return _gmm_grads_ok(got, GR.expert_ffn_grads_ref(*ins, dy), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,d,ff", GMM_BWD_COMMON)
def test_cuda_moe_gmm_bwd_keeps_h_precision(cuda_device, e, m, d, ff):
    """dw2 from h's hi + lo pair passes; dg and du, each rounded once to
    bf16, pass dx, dw1 and dw3."""
    from repro_torch.kernels.moe_gmm import ops as GO
    from repro_torch.kernels.moe_gmm import ref as GR
    assert all(_gmm_bwd_common(GO, GR, e, m, d, ff, cuda_device))


@pytest.mark.cuda
def test_cuda_moe_gmm_bwd_checks_catch_h_rounded_once(cuda_device, tmp_path,
                                                      monkeypatch):
    """A copy of moe_gmm_bwd.cu without the h_lo product (h rounded once
    to bf16 in dw2) fails dw2, and only dw2, in every common-part case."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_gmm import ops as GO
    from repro_torch.kernels.moe_gmm import ref as GR
    old, new = GR.BWD_ROUND_FAULT
    source = GO._BWD_SOURCE.read_text()
    assert source.count(old) == 1
    mutant = tmp_path / "moe_gmm_bwd.cu"
    mutant.write_text(source.replace(old, new))
    so = tmp_path / "libmoe_gmm_bwd_fault.so"
    _build.compile_to("moe_gmm_bwd_fault", mutant, so)
    lib = _build.bind(ctypes.CDLL(str(so)), GO._BWD_SIG)
    monkeypatch.setattr(GO, "bwd_lib", lambda: lib)
    for e, m, d, ff in GMM_BWD_COMMON:
        ok = _gmm_bwd_common(GO, GR, e, m, d, ff, cuda_device)
        print(f"gmm-bwd-fault E {e} M {m} d {d} ff {ff} ok {ok}", flush=True)
        assert ok == [True, True, False, True], (e, m, d, ff, ok)


# mamba_scan's gates: "jax" draws dt = softplus(N(0, 1)), about 0.8, with
# a = -exp(N(0, 0.3)), about -1 (the JAX kernel test's kind), under which
# exp(sum dt a) over a 64-token chunk is e^-45 or less: nothing of the
# state outlives a chunk.  "slow" draws dt = softplus(N(-4.6, 0.1)),
# about 0.01 (trained Mamba2's regime: its dt init range is [1e-3, 0.1]),
# so a chunk decays by about e^-0.64 and the state carries over several
# chunks.  (mean, std) of dt's pre-activation.
SCAN_GATES = {"jax": (0.0, 1.0), "slow": (-4.6, 0.1)}
SCAN_SLOW = [(1, 1024, 80, 64, 64, 64), (1, 256, 80, 64, 64, 64),
             (4, 512, 80, 64, 64, 64)]
SCAN_CASES = [c + ("jax",) for c in [
    (1, 1024, 80, 64, 64, 64), (1, 64, 80, 64, 64, 64),
    (1, 256, 80, 64, 64, 64), (1, 40, 80, 64, 64, 64),
    (4, 512, 80, 64, 64, 64), (2, 128, 3, 32, 16, 32),
    (1, 256, 2, 64, 64, 64), (2, 64, 2, 16, 8, 16), (1, 64, 2, 24, 16, 32)]
    ] + [c + ("slow",) for c in SCAN_SLOW]


def _scan_inputs(b, length, h, p, n, dtype, device, seed, gates="jax",
                 common=False):
    """With ``common`` b has a large part common to all its N entries (32
    + N(0, 0.5)) and c none (each row's mean taken out), so the state S,
    made of b, is large while C S^T cancels its common part: a rounding of
    S as an operand of C S^T shows in y."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    x = (torch.randn((b, length, h, p), generator=gen, device=device)
         * 0.5).to(dt)
    mean, std = SCAN_GATES[gates]
    dtt = torch.nn.functional.softplus(
        torch.randn((b, length, h), generator=gen, device=device) * std
        + mean)
    a = -torch.exp(torch.randn((h,), generator=gen, device=device) * 0.3)
    bb, cc = (torch.randn((b, length, n), generator=gen, device=device)
              * 0.5 for _ in range(2))
    if common:
        bb, cc = bb + 32.0, cc - cc.mean(-1, keepdim=True)
    return x, dtt, a, bb.to(dt), cc.to(dt)


def _scan_errors(SO, SR, case, dtype, device, common=False):
    """One case through the kernel and the plain version: the checks'
    readings (max errors, whether y and the state pass SCAN_TOL, the
    carry share)."""
    b, length, h, p, n, chunk, gates = case
    ins = _scan_inputs(b, length, h, p, n, dtype, device, length + h, gates,
                       common)
    before = SO.launches
    y, s = SO.ssd(*ins, chunk=chunk)
    assert SO.launches == before + 1
    yr, sr = SR.ssd_chunked(*ins, chunk)
    torch.cuda.synchronize()
    assert y.dtype == ins[0].dtype and s.dtype == torch.float32
    assert s.shape == (b, h, p, n)
    tol = SCAN_TOL[dtype]
    return {"y_max_abs_err": (y.float() - yr.float()).abs().max().item(),
            "state_max_abs_err": (s - sr).abs().max().item(),
            "y_ok": torch.allclose(y.float(), yr.float(), atol=tol["y"][0],
                                   rtol=tol["y"][1]),
            "state_ok": torch.allclose(s, sr, atol=tol["state"][0],
                                       rtol=tol["state"][1]),
            "carry_share": SR.carry_share(*ins, chunk, sr)}


@pytest.mark.cuda
@pytest.mark.parametrize("b,length,h,p,n,chunk,gates", SCAN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mamba_scan_matches_plain(cuda_device, b, length, h, p, n,
                                       chunk, gates, dtype):
    from repro_torch.kernels.mamba_scan import ops as SO
    from repro_torch.kernels.mamba_scan import ref as SR
    row = _scan_errors(SO, SR, (b, length, h, p, n, chunk, gates), dtype,
                       cuda_device)
    assert row["y_ok"] and row["state_ok"], row
    if gates == "slow":       # the data makes the carry between chunks count
        assert row["carry_share"] > 0.1, row


# Faults planted in a copy of csrc/mamba_scan.cu (built into a temporary
# directory, never into the repository): the factor that carries the
# state from one chunk into the next (state_carry, read by both routes),
# set to 0 or 1.  The checks above must fail on every case with slow
# gates, in both dtypes.
SCAN_FAULTS = {"carry_0": SR.FWD_CARRY_FAULT,
               "carry_1": (SR.FWD_CARRY_FAULT[0], "return 1.f;")}


def _mutant_lib(ops, tmp_path, monkeypatch, name, old, new):
    """A copy of ``ops``'s source with ``old`` (found once) replaced by
    ``new``, built into ``tmp_path`` and bound in place of ``ops.lib``."""
    import ctypes

    from repro_torch.kernels import _build
    source = ops._SOURCE.read_text()
    assert source.count(old) == 1
    mutant = tmp_path / ops._SOURCE.name
    mutant.write_text(source.replace(old, new))
    so = tmp_path / f"lib{name}.so"
    _build.compile_to(name, mutant, so)
    lib = _build.bind(ctypes.CDLL(str(so)), ops._SIG)
    monkeypatch.setattr(ops, "lib", lambda: lib)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(SCAN_FAULTS))
def test_cuda_mamba_scan_checks_catch_carry_faults(cuda_device, tmp_path,
                                                   monkeypatch, fault):
    import json

    from repro_torch.kernels.mamba_scan import ops as SO
    from repro_torch.kernels.mamba_scan import ref as SR
    _mutant_lib(SO, tmp_path, monkeypatch, "mamba_scan_fault",
                *SCAN_FAULTS[fault])
    caught = {}
    for dtype in ("float32", "bfloat16"):
        for case in [c + ("slow",) for c in SCAN_SLOW]:
            row = _scan_errors(SO, SR, case, dtype, cuda_device)
            caught[case + (dtype,)] = not (row["y_ok"] and row["state_ok"])
            row.update(fault=fault, B=case[0], L=case[1], dtype=dtype)
            print(f"scan-fault {json.dumps(row)}", flush=True)
    assert all(caught.values()), caught


# bf16 cases whose state has a large common part (_scan_inputs' common):
# a kernel that rounds the state S once as an operand of C S^T fails
# them.  The "rounded once" fault keeps only the product of S's first
# bf16 part (the kernel takes three).
SCAN_COMMON = [(1, 1024, 80, 64, 64, 64, "slow"),
               (1, 256, 80, 64, 64, 64, "slow")]
SCAN_ROUND_FAULT = (
    "for (int k = 0; k < NPART; ++k) {   // the state's parts",
    "for (int k = 0; k < 1; ++k) {   // the state's parts")


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_COMMON)
def test_cuda_mamba_scan_keeps_state_precision(cuda_device, case):
    from repro_torch.kernels.mamba_scan import ops as SO
    from repro_torch.kernels.mamba_scan import ref as SR
    row = _scan_errors(SO, SR, case, "bfloat16", cuda_device, common=True)
    assert row["y_ok"] and row["state_ok"], row


@pytest.mark.cuda
def test_cuda_mamba_scan_checks_catch_state_rounded_once(
        cuda_device, tmp_path, monkeypatch):
    """A copy of mamba_scan.cu whose C S^T keeps only S's first bf16 part
    fails every common-part case."""
    import json

    from repro_torch.kernels.mamba_scan import ops as SO
    from repro_torch.kernels.mamba_scan import ref as SR
    _mutant_lib(SO, tmp_path, monkeypatch, "mamba_scan_round",
                *SCAN_ROUND_FAULT)
    caught = {}
    for case in SCAN_COMMON:
        row = _scan_errors(SO, SR, case, "bfloat16", cuda_device,
                           common=True)
        caught[case] = not (row["y_ok"] and row["state_ok"])
        print(f"scan-round-fault {json.dumps(row)}", flush=True)
    assert all(caught.values()), caught


@pytest.mark.cuda
def test_cuda_mamba_scan_refusals(cuda_device):
    from repro_torch.kernels.mamba_scan import ops as SO
    x, dtt, a, bb, cc = _scan_inputs(1, 96, 2, 16, 8, "float32",
                                     cuda_device, 0)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        SO.ssd(x, dtt, a, bb, cc, chunk=64)
    with pytest.raises(ValueError, match="chunk"):
        SO.ssd(x, dtt, a, bb, cc, chunk=96)
    with pytest.raises(TypeError, match="dtypes"):
        SO.ssd(x, dtt, a, bb.bfloat16(), cc, chunk=32)
    # a gradient goes through the backward kernel (since its slice; the
    # wrapper refused it before), once a call, and matches the kernel's
    # own launch; P past the backward's tiles is refused
    before = (SO.launches, SO.bwd_launches)
    leaves = [t.clone().requires_grad_() for t in (x, dtt, a, bb, cc)]
    y, _ = SO.ssd(*leaves, chunk=32)
    dy = torch.randn_like(y)
    grads = torch.autograd.grad(y, leaves, dy)
    assert (SO.launches, SO.bwd_launches) == (before[0] + 1, before[1] + 1)
    for g, r in zip(grads, SO._launch_bwd(x, dtt, a, bb, cc, dy, None, 32)):
        assert torch.equal(g, r)
    wide = torch.zeros((1, 64, 1, 72), device=cuda_device)
    with pytest.raises(ValueError, match="backward"):
        SO._launch_bwd(wide, dtt[:, :64, :1].contiguous(), a[:1].contiguous(),
                       bb[:, :64].contiguous(), cc[:, :64].contiguous(),
                       wide, None, 32)


# mlstm: f32 sums over hd_k (up to 1024 terms) in another order than the
# plain version's; the error follows the size of the terms, so the
# absolute tolerance scales with the output's largest magnitude.  bf16 h
# is rounded once from f32 in both, so the two differ by at most one bf16
# ulp (2^-8 to 2^-7 of the value) where their f32 values straddle a
# rounding boundary: atol and rtol of two ulps, 8e-3.  m is a log-domain
# stabiliser (the JAX tests' atol 1e-3).
MLSTM_TOL = {"float32": 1e-4, "bfloat16": 8e-3}
# Forget gates: "jax" is the JAX kernel test's -softplus(N(0, 1)), about
# -0.8 a token, under which nothing of C outlives a chunk; "model" is
# log sigmoid(N(3, 1)), the model's forget bias of 3; "slow" is
# log sigmoid(N(4.6, 0.1)), about -0.01, so that C and n carry over
# several chunks.
MLSTM_GATES = {"jax": (-1.0, 0.0, 1.0), "model": (1.0, 3.0, 1.0),
               "slow": (1.0, 4.6, 0.1)}
MLSTM_BIG = [(1, 1024, 4, 1024, 128, False), (1, 1000, 4, 1024, 128, False),
             (4, 512, 4, 1024, 128, False), (1, 300, 4, 1024, 128, True)]
MLSTM_CASES = [c + (g,) for g in ("model", "slow") for c in MLSTM_BIG] + [
    (2, 128, 2, 32, 32, False, "jax"), (1, 256, 4, 64, 64, False, "jax"),
    (2, 64, 1, 16, 16, False, "jax"), (2, 100, 2, 48, 32, True, "jax"),
    (1, 37, 2, 8, 16, True, "jax"), (2, 100, 2, 48, 32, True, "slow"),
    (1, 37, 2, 8, 16, True, "slow")]


def _mlstm_inputs(b, length, h, hd, dtype, device, seed, state=False,
                  gates="jax", common=False):
    """With ``common`` (and a state) the initial C has a large part common
    to all its entries (30 + N(0, 0.3)) and q none (each row's mean over
    hd taken out), so Q C^T cancels C's common part: a rounding of C as an
    operand of Q C^T shows in h."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((b, length, h, hd), generator=gen,
                           device=device) for _ in range(3))
    if common:
        q = q - q.mean(-1, keepdim=True)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    li = torch.randn((b, length, h), generator=gen, device=device) - 1
    sign, mean, std = MLSTM_GATES[gates]
    x = torch.randn((b, length, h), generator=gen, device=device) * std + mean
    lf = -torch.nn.functional.softplus(x) if sign < 0 \
        else torch.nn.functional.logsigmoid(x)
    st = None
    if state:
        st = (torch.randn((b, h, hd, hd), generator=gen, device=device) * .3
              + (30.0 if common else 0.0),
              torch.randn((b, h, hd), generator=gen, device=device) * .3,
              torch.randn((b, h), generator=gen, device=device))
    return (q, k, v, li, lf), st


def _mlstm_carry_share(MR, ins, st, chunk, c, m):
    """max |C - C'| / max |C|, unstabilised, where C' is the plain
    version's final C from the last chunk alone and a zero state: how
    much the earlier chunks (and the initial state) carry into C."""
    lo = (ins[0].shape[1] - 1) // chunk * chunk
    _, (c1, _, m1) = MR.mlstm_chunked(*(t[:, lo:] for t in ins), None,
                                      chunk)
    top = m.amax()
    full = c * (m - top)[..., None, None].exp()
    last = c1 * (m1 - top)[..., None, None].exp()
    return ((full - last).abs().max() / full.abs().max()).item()


def _mlstm_tols(dtype, ref, cr, nr):
    """(atol, rtol) for h, C, n and m, the kernel checks' criteria."""
    tol = MLSTM_TOL[dtype]
    scale = lambda t: max(1.0, t.float().abs().max().item())
    return {"h": (tol * scale(ref), tol), "c": (1e-4 * scale(cr), 1e-3),
            "n": (1e-4 * scale(nr), 1e-3), "m": (1e-3, 0.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("b,length,h,hd,chunk,state,gates", MLSTM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mlstm_matches_plain(cuda_device, b, length, h, hd, chunk,
                                  state, gates, dtype):
    from repro_torch.kernels.mlstm import ops as MO
    from repro_torch.kernels.mlstm import ref as MR
    ins, st = _mlstm_inputs(b, length, h, hd, dtype, cuda_device,
                            length + hd, state, gates)
    before = MO.launches
    out, (c, n, m) = MO.mlstm(*ins, st, chunk=chunk)
    assert MO.launches == before + 1
    ref, (cr, nr, mr) = MR.mlstm_chunked(*ins, st, chunk)
    torch.cuda.synchronize()
    assert out.dtype == ins[0].dtype and c.dtype == torch.float32
    tols = _mlstm_tols(dtype, ref, cr, nr)
    for name, got, want in (("h", out.float(), ref.float()), ("c", c, cr),
                            ("n", n, nr), ("m", m, mr)):
        atol, rtol = tols[name]
        torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    if gates == "slow":       # the data makes the carry between chunks count
        assert _mlstm_carry_share(MR, ins, st, chunk, cr, mr) > 0.1


def _mlstm_errors(MO, MR, case, dtype, device, common=False):
    """One case through the kernel and the plain version: each output's
    max error and whether it passes _mlstm_tols."""
    b, length, h, hd, chunk, state, gates = case
    ins, st = _mlstm_inputs(b, length, h, hd, dtype, device, length + hd,
                            state, gates, common)
    out, (c, n, m) = MO.mlstm(*ins, st, chunk=chunk)
    ref, (cr, nr, mr) = MR.mlstm_chunked(*ins, st, chunk)
    tols = _mlstm_tols(dtype, ref, cr, nr)
    row = {"B": b, "L": length, "hd": hd, "state": state, "gates": gates,
           "dtype": dtype}
    for name, got, want in (("h", out.float(), ref.float()), ("c", c, cr),
                            ("n", n, nr), ("m", m, mr)):
        atol, rtol = tols[name]
        row[f"{name}_max_abs_err"] = (got - want).abs().max().item()
        row[f"{name}_ok"] = torch.allclose(got, want, atol=atol, rtol=rtol)
    return row


# Faults planted in a copy of csrc/mlstm.cu (built into a temporary
# directory, never into the repository): the factor that carries C from
# one chunk into the next (c_carry, read by both routes' state passes),
# set to 0 or 1, and the carry of n in the gate pass dropped.  The checks
# above must fail on every case with slow gates, in both dtypes; the
# readings show the cases with the model's gates (f32) too.
MLSTM_FAULTS = {
    "c_carry_0": ("return gcarry[cb];", "return 0.f;"),
    "c_carry_1": ("return gcarry[cb];", "return 1.f;"),
    "n_carry_0": ("n_run = carry * n_run + s;", "n_run = s;"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(MLSTM_FAULTS))
def test_cuda_mlstm_checks_catch_carry_faults(cuda_device, tmp_path,
                                              monkeypatch, fault):
    import json

    from repro_torch.kernels.mlstm import ops as MO
    from repro_torch.kernels.mlstm import ref as MR
    _mutant_lib(MO, tmp_path, monkeypatch, "mlstm_fault",
                *MLSTM_FAULTS[fault])
    caught = {}
    cases = [(c + ("slow",), d) for d in ("float32", "bfloat16")
             for c in MLSTM_BIG] + [(c + ("model",), "float32")
                                    for c in MLSTM_BIG]
    for case, dtype in cases:
        row = _mlstm_errors(MO, MR, case, dtype, cuda_device)
        row["fault"] = fault
        caught[case + (dtype,)] = not all(row[f"{x}_ok"] for x in "hcnm")
        print(f"mlstm-fault {json.dumps(row)}", flush=True)
    assert all(hit for case, hit in caught.items() if case[-2] == "slow"), \
        caught


# bf16 cases whose initial C has a large common part (_mlstm_inputs'
# common): a kernel that rounds C once as an operand of Q C^T fails them.
# The "rounded once" fault keeps only the product of C's first bf16 part.
MLSTM_COMMON = [(1, 300, 4, 1024, 128, True, "slow"),
                (1, 130, 1, 64, 128, True, "slow")]
MLSTM_ROUND_FAULT = (
    "          for (int p = 1; p < NPART; ++p) {     // C's lower parts\n",
    "          for (int p = 1; p < 1; ++p) {     // C's lower parts\n")


@pytest.mark.cuda
@pytest.mark.parametrize("case", MLSTM_COMMON)
def test_cuda_mlstm_keeps_c_precision(cuda_device, case):
    from repro_torch.kernels.mlstm import ops as MO
    from repro_torch.kernels.mlstm import ref as MR
    row = _mlstm_errors(MO, MR, case, "bfloat16", cuda_device, common=True)
    assert all(row[f"{x}_ok"] for x in "hcnm"), row


@pytest.mark.cuda
def test_cuda_mlstm_checks_catch_c_rounded_once(cuda_device, tmp_path,
                                                monkeypatch):
    """A copy of mlstm.cu whose Q C^T keeps only C's first bf16 part fails
    every common-part case."""
    import json

    from repro_torch.kernels.mlstm import ops as MO
    from repro_torch.kernels.mlstm import ref as MR
    _mutant_lib(MO, tmp_path, monkeypatch, "mlstm_round",
                *MLSTM_ROUND_FAULT)
    caught = {}
    for case in MLSTM_COMMON:
        row = _mlstm_errors(MO, MR, case, "bfloat16", cuda_device,
                            common=True)
        caught[case] = not all(row[f"{x}_ok"] for x in "hcnm")
        print(f"mlstm-round-fault {json.dumps(row)}", flush=True)
    assert all(caught.values()), caught


@pytest.mark.cuda
def test_cuda_mlstm_precision_at_training_shape(cuda_device, tmp_path,
                                                monkeypatch):
    """xlstm-1.3b's training shape (B 2, L 512, 4 heads of hd 1024, chunk
    128), bf16, slow gates: the kernel's h and final C pass
    ``ref.precision`` (against float64, the plain version as the
    yardstick); a copy with its f32 operands in two bf16 parts
    (``ref.FWD_PARTS_FAULT``: the kernel as it was) fails it."""
    import json

    from repro_torch.kernels.mlstm import ops as MO
    from repro_torch.kernels.mlstm import ref as MR
    ins = MR.grad_inputs(2, 512, 4, 1024, gates="slow",
                         dtype=torch.bfloat16, seed=1536,
                         device=cuda_device)[:5]
    rows = {}
    for tag in ("kernel", "two_parts"):
        if tag == "two_parts":
            _mutant_lib(MO, tmp_path, monkeypatch, "mlstm_parts",
                        *MR.FWD_PARTS_FAULT)
        h, (c, _, _) = MO.mlstm(*ins, chunk=128)
        torch.cuda.synchronize()
        rows[tag] = MR.precision(h, c, *ins, 128)
        print(f"mlstm-precision {tag} {json.dumps(rows[tag])}", flush=True)
    assert rows["kernel"]["ok"] and not rows["two_parts"]["ok"], rows


@pytest.mark.cuda
def test_cuda_mlstm_refusals(cuda_device):
    from repro_torch.kernels.mlstm import ops as MO
    (q, k, v, li, lf), st = _mlstm_inputs(1, 64, 2, 16, "float32",
                                          cuda_device, 0, state=True)
    (ql, kl, vl, lil, lfl), _ = _mlstm_inputs(1, 300, 2, 16, "float32",
                                              cuda_device, 1)
    with pytest.raises(ValueError, match="chunk"):
        MO.mlstm(ql, kl, vl, lil, lfl, chunk=256)
    with pytest.raises(ValueError, match="head dim"):
        MO.mlstm(*(t[..., :6].contiguous() for t in (q, k, v)), li, lf)
    with pytest.raises(TypeError, match="dtypes"):
        MO.mlstm(q, k.bfloat16(), v, li, lf)
    with pytest.raises(TypeError, match="one CUDA device"):
        MO.mlstm(q, k, v, li, lf, tuple(t.cpu() for t in st))
    # a gradient from the zero state goes through the backward kernel
    # (since its slice; the wrapper refused it before), once a call, and
    # matches the kernel's own launch
    before = (MO.launches, MO.bwd_launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, li, lf)]
    out, _ = MO.mlstm(*leaves)
    dh = torch.randn_like(out)
    grads = torch.autograd.grad(out, leaves, dh)
    assert (MO.launches, MO.bwd_launches) == (before[0] + 1, before[1] + 1)
    for g, r in zip(grads, MO._launch_bwd(q, k, v, li, lf, dh, 128)):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_cuda_mlstm_refuses_state_gradients(cuda_device):
    """The backward kernel runs from the zero state with the final state's
    gradient 0, as training calls it: a gradient through an initial state,
    or one that reaches the final (c, n, m), raises naming ROADMAP rather
    than come out wrong; without a gradient the initial state is taken."""
    from repro_torch.kernels.mlstm import ops as MO
    (q, k, v, li, lf), st = _mlstm_inputs(1, 64, 2, 16, "float32",
                                          cuda_device, 0, state=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MO.mlstm(q.clone().requires_grad_(), k, v, li, lf, st)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MO.mlstm(q, k, v, li, lf, (st[0].clone().requires_grad_(), *st[1:]))
    qg = q.clone().requires_grad_()
    out, (c, n, m) = MO.mlstm(qg, k, v, li, lf)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch.autograd.grad(out.sum() + c.sum(), qg)
    out, _ = MO.mlstm(q, k, v, li, lf, st)        # no gradient: taken
    assert bool(torch.isfinite(out).all())


def _mutant_bwd_lib(ops, tmp_path, monkeypatch, name, old, new):
    """A copy of ``ops``'s backward source with ``old`` (found once)
    replaced by ``new``, built into ``tmp_path`` and bound in place of
    ``ops.bwd_lib``."""
    import ctypes

    from repro_torch.kernels import _build
    source = ops._BWD_SOURCE.read_text()
    assert source.count(old) == 1
    mutant = tmp_path / ops._BWD_SOURCE.name
    mutant.write_text(source.replace(old, new))
    so = tmp_path / f"lib{name}.so"
    _build.compile_to(name, mutant, so)
    lib = _build.bind(ctypes.CDLL(str(so)), ops._BWD_SIG)
    monkeypatch.setattr(ops, "bwd_lib", lambda: lib)


def _grads_ok(got, ref, tol):
    """Each gradient finite and within rtol ``tol`` and an atol of ``tol``
    times its largest magnitude of autograd of the plain version."""
    return [bool(torch.isfinite(g.float()).all()) and torch.allclose(
        g.float(), r.float(), rtol=tol,
        atol=tol * max(1.0, r.abs().max().item())) for g, r in zip(got, ref)]


# mamba_scan's backward: f32 sums of up to chunk x H terms in another order
# (the tolerance scales with each gradient's largest magnitude); bf16 adds
# one rounding of dx, db and dc.  zamba2's training shape (rank batch 2 x
# 1024, H 80, P 64, N 64, chunk 64) with the model's gates and slow ones,
# and small shapes.
SCAN_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
SCAN_BWD_CASES = [(2, 1024, 80, 64, 64, 64, "model", False),
                  (2, 1024, 80, 64, 64, 64, "slow", False),
                  (1, 256, 4, 32, 16, 32, "slow", True),
                  (2, 128, 3, 24, 12, 32, "slow", True)]


def _scan_bwd_ok(SO, SR, case, dtype, device, inputs="random"):
    b, length, h, p, n, chunk, gates, with_ds = case
    x, dtt, a, bb, cc, dy = SR.scan_inputs(
        b, length, h, p, n, gates=gates, inputs=inputs,
        dtype=getattr(torch, dtype), seed=length + h, device=device)
    ds = (torch.randn((b, h, p, n), device=device) if with_ds else None)
    got = SO._launch_bwd(x, dtt, a, bb, cc, dy, ds, chunk)
    ref = SR.ssd_chunked_grads(x, dtt, a, bb, cc, chunk, dy, ds)
    torch.cuda.synchronize()
    _, s = SR.ssd_chunked(x, dtt, a, bb, cc, chunk)
    return (_grads_ok(got, ref, SCAN_BWD_TOL[dtype]),
            SR.carry_share(x, dtt, a, bb, cc, chunk, s))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mamba_scan_bwd_matches_autograd_of_plain(cuda_device, case,
                                                       dtype):
    from repro_torch.kernels.mamba_scan import ops as SO
    from repro_torch.kernels.mamba_scan import ref as SR
    ok, share = _scan_bwd_ok(SO, SR, case, dtype, cuda_device)
    assert all(ok), ok
    if case[6] == "slow":
        assert share > 0.1, share


@pytest.mark.cuda
def test_cuda_mamba_scan_bwd_is_deterministic(cuda_device):
    from repro_torch.kernels.mamba_scan import ops as SO
    from repro_torch.kernels.mamba_scan import ref as SR
    ins = SR.scan_inputs(2, 1024, 80, 64, 64, dtype=torch.bfloat16,
                         device=cuda_device)
    one = SO._launch_bwd(*ins, None, 64)
    two = SO._launch_bwd(*ins, None, 64)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.cuda
def test_cuda_mamba_scan_bwd_checks_catch_a_dropped_carry(
        cuda_device, tmp_path, monkeypatch):
    """A copy of mamba_scan_bwd.cu whose reverse walk drops the carry of dS
    into the chunk before (ref.BWD_CARRY_FAULT) fails the slow-gate
    cases, in both dtypes."""
    from repro_torch.kernels.mamba_scan import ops as SO
    from repro_torch.kernels.mamba_scan import ref as SR
    _mutant_bwd_lib(SO, tmp_path, monkeypatch, "mamba_scan_bwd_fault",
                    *SR.BWD_CARRY_FAULT)
    for dtype in ("float32", "bfloat16"):
        for case in SCAN_BWD_CASES[1:3]:
            ok, _ = _scan_bwd_ok(SO, SR, case, dtype, cuda_device)
            assert not all(ok), (case, dtype, ok)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [SCAN_BWD_CASES[1], SCAN_BWD_CASES[2]])
def test_cuda_mamba_scan_bwd_keeps_state_precision(cuda_device, case):
    """bf16 common-part inputs (ref.scan_inputs(inputs="common"): states
    with a large common part that dY S_in cancels): the tensor-core
    route, S_in in three bf16 parts, passes."""
    from repro_torch.kernels.mamba_scan import ops as SO
    from repro_torch.kernels.mamba_scan import ref as SR
    ok, share = _scan_bwd_ok(SO, SR, case, "bfloat16", cuda_device,
                             "common")
    assert all(ok), ok
    assert share > 0.1, share


@pytest.mark.cuda
def test_cuda_mamba_scan_bwd_checks_catch_state_rounded_once(
        cuda_device, tmp_path, monkeypatch):
    """A copy of mamba_scan_bwd.cu whose dY S_in takes only S_in's first
    bf16 part (ref.BWD_ROUND_FAULT) fails the common-part cases."""
    from repro_torch.kernels.mamba_scan import ops as SO
    from repro_torch.kernels.mamba_scan import ref as SR
    _mutant_bwd_lib(SO, tmp_path, monkeypatch, "mamba_scan_bwd_round",
                    *SR.BWD_ROUND_FAULT)
    for case in SCAN_BWD_CASES[1:3]:
        ok, _ = _scan_bwd_ok(SO, SR, case, "bfloat16", cuda_device,
                             "common")
        assert not all(ok), (case, ok)


# mlstm's backward: f32 sums over hd or the chunk in another order (the
# tolerance scales with each gradient's largest magnitude); bf16 adds one
# rounding of dq, dk and dv.  xlstm-1.3b's training shape (rank batch 2 x
# 512, 4 heads of hd 1024, chunk 128) with slow forget gates, inputs whose
# floor binds on few rows and on most (ref.grad_inputs), a ragged tail.
MLSTM_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
MLSTM_BWD_CASES = [(2, 512, 4, 1024, 128, "slow", "random"),
                   (2, 512, 4, 1024, 128, "slow", "floor"),
                   (2, 512, 4, 1024, 128, "model", "random"),
                   (1, 300, 2, 64, 128, "slow", "random"),
                   (2, 100, 2, 48, 32, "jax", "random")]


def _mlstm_bwd_ok(MO, MR, case, dtype, device):
    """Each gradient's check (``_grads_ok``) and the floor's share; the
    case's inputs kind is ref.grad_inputs's ("random", "floor",
    "common")."""
    b, length, h, hd, chunk, gates, inputs = case
    q, k, v, li, lf, dh = MR.grad_inputs(
        b, length, h, hd, gates=gates, inputs=inputs,
        dtype=getattr(torch, dtype), seed=length + hd, device=device)
    got = MO._launch_bwd(q, k, v, li, lf, dh, chunk)
    ref = MR.mlstm_chunked_grads(q, k, v, li, lf, chunk, dh)
    torch.cuda.synchronize()
    return (_grads_ok(got, ref, MLSTM_BWD_TOL[dtype]),
            MR.floor_share(q, k, v, li, lf, chunk))


@pytest.mark.cuda
@pytest.mark.parametrize("case", MLSTM_BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mlstm_bwd_matches_autograd_of_plain(cuda_device, case, dtype):
    from repro_torch.kernels.mlstm import ops as MO
    from repro_torch.kernels.mlstm import ref as MR
    ok, share = _mlstm_bwd_ok(MO, MR, case, dtype, cuda_device)
    assert all(ok), ok
    if case[6] == "floor":
        assert share > 0.5, share


@pytest.mark.cuda
def test_cuda_mlstm_bwd_is_deterministic(cuda_device):
    from repro_torch.kernels.mlstm import ops as MO
    from repro_torch.kernels.mlstm import ref as MR
    ins = MR.grad_inputs(2, 512, 4, 1024, dtype=torch.bfloat16,
                         device=cuda_device)
    one = MO._launch_bwd(*ins, 128)
    two = MO._launch_bwd(*ins, 128)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.cuda
@pytest.mark.parametrize("fault,cases", [("carry", (0, 3)),
                                         ("floor", (1,))])
def test_cuda_mlstm_bwd_checks_catch_planted_faults(cuda_device, tmp_path,
                                                    monkeypatch, fault,
                                                    cases):
    """A copy of mlstm_bwd.cu whose reverse walk drops the carry of (dC,
    dn) (ref.BWD_CARRY_FAULT) fails the slow-gate cases; one that ignores
    the floor's branch (ref.BWD_FLOOR_FAULT) fails the case whose floor
    binds on most rows; both dtypes."""
    from repro_torch.kernels.mlstm import ops as MO
    from repro_torch.kernels.mlstm import ref as MR
    old, new = {"carry": MR.BWD_CARRY_FAULT,
                "floor": MR.BWD_FLOOR_FAULT}[fault]
    _mutant_bwd_lib(MO, tmp_path, monkeypatch, f"mlstm_bwd_{fault}", old,
                    new)
    for dtype in ("float32", "bfloat16"):
        for i in cases:
            ok, _ = _mlstm_bwd_ok(MO, MR, MLSTM_BWD_CASES[i], dtype,
                                  cuda_device)
            assert not all(ok), (MLSTM_BWD_CASES[i], dtype, ok)


@pytest.mark.cuda
def test_cuda_mlstm_bwd_keeps_state_precision(cuda_device):
    """bf16 common-part inputs (ref.grad_inputs(inputs="common"): states C
    with a large common part that U = dH C cancels) at xlstm's training
    shape: the tensor-core products, C as a hi + lo pair, pass."""
    from repro_torch.kernels.mlstm import ops as MO
    from repro_torch.kernels.mlstm import ref as MR
    ok, _ = _mlstm_bwd_ok(MO, MR, (2, 512, 4, 1024, 128, "slow", "common"),
                          "bfloat16", cuda_device)
    assert all(ok), ok


@pytest.mark.cuda
def test_cuda_mlstm_bwd_checks_catch_state_rounded_once(
        cuda_device, tmp_path, monkeypatch):
    """A copy of mlstm_bwd.cu whose U = dH C takes only C's first bf16 part
    (ref.BWD_ROUND_FAULT) fails the common-part case."""
    from repro_torch.kernels.mlstm import ops as MO
    from repro_torch.kernels.mlstm import ref as MR
    _mutant_bwd_lib(MO, tmp_path, monkeypatch, "mlstm_bwd_round",
                    *MR.BWD_ROUND_FAULT)
    ok, _ = _mlstm_bwd_ok(MO, MR, (2, 512, 4, 1024, 128, "slow", "common"),
                          "bfloat16", cuda_device)
    assert not all(ok), ok


# The long_500k and prefill_32k shapes (slice 17).  Their plain versions
# run a piece at a time: attention_ref_blocked a block of query rows at a
# time against the keys its window reaches, and ssd_chunked
# LONG_SCAN_HEADS heads at a time (the heads are independent), since the
# whole (S, S) logits or the scan's f32 intermediates of 80 heads at 524k
# tokens do not fit the card.
LONG = 524288
LONG_WINDOW = 4096
LONG_SCAN_HEADS = 8


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv,hd", [(32, 8, 64), (32, 2, 128)])
def test_cuda_flash_matches_plain_at_32k(cuda_device, h, kv, hd):
    """Causal bf16 flash at prefill_32k's length, llama3.2-1b's heads and
    glm4-9b's (group 16, hd 128)."""
    s = 32768
    gen = torch.Generator(device=cuda_device).manual_seed(hd)
    q, k, v = (torch.randn((1, s, n, hd), generator=gen,
                           device=cuda_device).to(torch.bfloat16)
               for n in (h, kv, kv))
    out = TO.flash_attention(q, k, v, causal=True)
    ref = TR.attention_ref_blocked(*(x.transpose(1, 2) for x in (q, k, v))
                                   ).transpose(1, 2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


def _long_flash_inputs(device):
    """zamba2-2.7b's heads (H 32 = KV 32, hd 80) at 524,288 tokens."""
    gen = torch.Generator(device=device).manual_seed(27)
    return tuple(torch.randn((1, LONG, 32, 80), generator=gen,
                             device=device).to(torch.bfloat16)
                 for _ in range(3))


@pytest.mark.cuda
def test_cuda_flash_window_at_524288(cuda_device, tmp_path, monkeypatch):
    """Causal flash with the long_500k window over 524,288 tokens (the
    padded q holds 2^31 elements) against the plain version; a copy
    without the online softmax's rescale fails it."""
    import ctypes

    from repro_torch.kernels import _build
    q, k, v = _long_flash_inputs(cuda_device)
    ref = TR.attention_ref_blocked(*(x.transpose(1, 2) for x in (q, k, v)),
                                   window=LONG_WINDOW).transpose(1, 2)
    out = TO.flash_attention(q, k, v, causal=True, window=LONG_WINDOW)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    del out
    old, new = TR.FWD_RESCALE_FAULT
    source = (TO._CSRC / "flash_attention.cu").read_text()
    mutant = tmp_path / "flash_attention.cu"
    mutant.write_text(source.replace(old, new))
    so = tmp_path / "libflash_rescale.so"
    _build.compile_to("flash_rescale", mutant, so)
    lib = _build.bind(ctypes.CDLL(str(so)), TO._FWD_SIG)
    monkeypatch.setattr(TO, "fwd_lib", lambda: lib)
    bad = TO.flash_attention(q, k, v, causal=True, window=LONG_WINDOW)
    assert not torch.allclose(bad.float(), ref.float(), atol=2e-2,
                              rtol=2e-2)


@pytest.mark.cuda
def test_cuda_mamba_scan_carry_over_8192_chunks(cuda_device, tmp_path,
                                                monkeypatch):
    """bf16 mamba_scan at (1, 524288, 80, 64, 64) with slow gates (x holds
    2.7e9 elements, past 2^31), where the state carried into the last
    chunk is more than a tenth of it, against the plain version; a copy
    that carries no state (ref.FWD_CARRY_FAULT) fails it."""
    from repro_torch.kernels.mamba_scan import ops as SO
    ins = _scan_inputs(1, LONG, 80, 64, 64, "bfloat16", cuda_device, 27,
                       "slow")
    ys, ss = [], []
    for h0 in range(0, 80, LONG_SCAN_HEADS):
        hs = slice(h0, h0 + LONG_SCAN_HEADS)
        y, s = SR.ssd_chunked(ins[0][:, :, hs], ins[1][:, :, hs],
                              ins[2][hs], ins[3], ins[4], 64)
        ys.append(y)
        ss.append(s)
    yr, sr = torch.cat(ys, dim=2), torch.cat(ss, dim=1)
    del ys, ss
    assert SR.carry_share(*ins, 64, sr) > 0.1
    tol = SCAN_TOL["bfloat16"]

    def ok(y, s):
        return (torch.allclose(y.float(), yr.float(), atol=tol["y"][0],
                               rtol=tol["y"][1])
                and torch.allclose(s, sr, atol=tol["state"][0],
                                   rtol=tol["state"][1]))
    assert ok(*SO.ssd(*ins, chunk=64))
    _mutant_lib(SO, tmp_path, monkeypatch, "mamba_scan_carry",
                *SR.FWD_CARRY_FAULT)
    assert not ok(*SO.ssd(*ins, chunk=64))
