"""The hand-written CUDA kernels against their plain PyTorch versions, on
a GPU.  Marked ``cuda``: they skip on a machine without one.  This file
imports neither JAX nor ``repro``, so it also runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as TO
from repro_torch.kernels.flash_attention import ref as TR


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,window,hd", [(1, 128, 0, 64), (1, 1000, 0, 64),
                                           (1, 1024, 256, 64), (1, 300, 0, 80),
                                           (4, 512, 0, 64)])
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
