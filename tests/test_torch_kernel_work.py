"""Each hand-written kernel's ``work()`` (flops, bytes) pinned to the
bound column of PERF.md §6 at that table's shapes (H100 SXM: 989 TFLOP/s
bf16, 67 TFLOP/s f32, 3.35 TB/s), and chip_smoke.py's bound helpers
taking their numbers from it.  Each expected bound is the table's figure
as printed, so the tolerance is half a unit in its last printed digit."""
import os
import sys

import pytest

from repro_torch.kernels.collective_codec import ops as co
from repro_torch.kernels.diff_merge import ops as dm
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.mamba_scan import ops as ms
from repro_torch.kernels.mlstm import ops as ml
from repro_torch.kernels.moe_gmm import ops as gmm

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

PEAK = {"bf16": 989e12, "f32": 67e12}
HBM = 3.35e12


def bound_ms(work, peak="bf16"):
    flops, nbytes = work
    return max(flops / PEAK[peak], nbytes / HBM) * 1e3


def printed(expected: str):
    """The value and half a unit in the last digit of ``expected``."""
    decimals = len(expected.split(".")[1])
    return float(expected), 0.5 * 10 ** -decimals


# Layer: the FLOPs each kernel does and the bytes it must move, shape by
# shape (PERF.md §6's bound column: the least time of each row's call)
CASES = [
    # flash forward: B 1 x 1024, H 32 / KV 8, hd 64 bf16; hd 128; group 1
    # (whisper, H 12 / KV 12); its training 2 x 448; granite's group 2
    ("flash fwd", fa.work(1, 32, 8, 1024, 64, True, 0, 2), "0.00435"),
    ("flash fwd hd128", fa.work(1, 32, 8, 1024, 128, True, 0, 2), "0.00869"),
    ("flash fwd group 1", fa.work(1, 12, 12, 1024, 64, True, 0, 2),
     "0.00188"),
    ("flash fwd 2x448", fa.work(2, 12, 12, 448, 64, True, 0, 2), "0.00164"),
    ("flash fwd group 2", fa.work(4, 16, 8, 1024, 64, True, 0, 2),
     "0.00869"),
    # flash backward: B 2 x 1024; group 1 2 x 448; hd 128; 1 x 1024 hd
    # 128; group 2 4 x 1024
    ("flash bwd", fa.bwd_work(2, 32, 8, 1024, 64, True, 0, 2), "0.0217"),
    ("flash bwd group 1", fa.bwd_work(2, 12, 12, 448, 64, True, 0, 2),
     "0.0033"),
    ("flash bwd hd128", fa.bwd_work(2, 32, 8, 1024, 128, True, 0, 2),
     "0.0435"),
    ("flash bwd 1x1024 hd128", fa.bwd_work(1, 32, 8, 1024, 128, True, 0, 2),
     "0.0217"),
    ("flash bwd group 2", fa.bwd_work(4, 16, 8, 1024, 64, True, 0, 2),
     "0.0217"),
    # the codec's main-path launch: 4 shards, 123,581,440 x 20
    ("codec", co.work(123_581_440, 20), "6.198"),
    # moe_gmm: granite (E 32, d 1024, ff 512) M 320 and M 1280; phi3.5
    # (E 16, d 4096, ff 6400) M 160
    ("gmm M320", gmm.work(32, 320, 1024, 512, "silu", 2), "0.0426"),
    ("gmm M1280", gmm.work(32, 1280, 1024, 512, "silu", 2), "0.1303"),
    ("gmm phi3.5", gmm.work(16, 160, 4096, 6400, "silu", 2), "0.764"),
    ("gmm bwd", gmm.bwd_work(32, 1280, 1024, 512, "silu", 2), "0.3474"),
    ("gmm bwd gelu", gmm.bwd_work(32, 1280, 1024, 512, "gelu", 2),
     "0.2171"),
    ("gmm bwd phi3.5", gmm.bwd_work(16, 160, 4096, 6400, "silu", 2),
     "1.5212"),
    # mamba_scan (H 80, P 64, N 64, chunk 64): B 1 x 1024; backward 2 x
    # 1024 and at the f32 CUDA-core peak
    ("scan", ms.work(1, 1024, 80, 64, 64, 64, 2), "0.0068"),
    ("scan bwd", ms.bwd_work(2, 1024, 80, 64, 64, 64, 2), "0.01948"),
    # mlstm (H 4, hd 1024, chunk 128): B 1 x 1024; backward 2 x 512
    ("mlstm", ml.work(1, 1024, 4, 1024, 128, False, 2), "0.0174"),
    ("mlstm bwd", ml.bwd_work(2, 512, 4, 1024, 128, 2), "0.03531"),
]


@pytest.mark.parametrize("name,work,expected", CASES,
                         ids=[c[0] for c in CASES])
def test_work_matches_perf_bound(name, work, expected):
    value, tol = printed(expected)
    assert bound_ms(work) == pytest.approx(value, abs=tol), name


@pytest.mark.parametrize("work,expected", [
    (ms.bwd_work(2, 1024, 80, 64, 64, 64, 2), "0.1209"),
    (ml.bwd_work(2, 512, 4, 1024, 128, 2), "0.5212"),
])
def test_work_at_the_f32_core_peak(work, expected):
    value, tol = printed(expected)
    assert bound_ms(work, "f32") == pytest.approx(value, abs=tol)


def _kernel_leaves():
    """The llama3.2-1b train state's leaves of 2^20 elements or more
    (the diff_merge kernel's): embed and the seven stacked projections,
    in params (bf16) and both f32 moments."""
    d, ff, kv, layers, vocab = 2048, 8192, 512, 16, 128256
    sizes = [vocab * d] + [layers * n for n in (d * d, d * kv, d * kv,
                                                d * d, d * ff, ff * d,
                                                d * ff)]
    return [(n, esize) for esize in (2, 4, 4) for n in sizes]


def test_diff_merge_work_over_the_train_state():
    # PERF.md §6: 14.76 ms (bytes) over the state's 24 kernel leaves
    leaves = _kernel_leaves()
    assert len(leaves) == 24
    total = sum(dm.work(n, e)[1] for n, e in leaves)
    value, tol = printed("14.76")
    assert total / HBM * 1e3 == pytest.approx(value, abs=tol)
    assert all(dm.work(n, e)[0] == 0.0 for n, e in leaves)


def test_chip_smoke_bounds_take_the_kernels_work():
    """chip_smoke.py's helpers report each kernel's work() unchanged."""
    ms_, by, flops = chip_smoke._bound(1, 32, 8, 1024, 64, True, 0,
                                       "bfloat16", 2)
    assert (flops, by) == (fa.work(1, 32, 8, 1024, 64, True, 0, 2)[0],
                           "operations")
    assert ms_ == pytest.approx(bound_ms(fa.work(1, 32, 8, 1024, 64, True,
                                                 0, 2)))
    assert chip_smoke._bwd_bound(2, 32, 8, 1024, 64, 0, "bfloat16", 2)[2] \
        == fa.bwd_work(2, 32, 8, 1024, 64, True, 0, 2)[0]
    assert chip_smoke._gmm_bound(32, 320, 1024, 512, "silu", "bfloat16",
                                 2)[2:4] == gmm.work(32, 320, 1024, 512,
                                                     "silu", 2)
    assert chip_smoke._gmm_bwd_bound(32, 1280, 1024, 512, "gelu",
                                     "bfloat16", 2)[2:4] == gmm.bwd_work(
        32, 1280, 1024, 512, "gelu", 2)
    assert chip_smoke._scan_bound(1, 1024, 80, 64, 64, 64, 2,
                                  "bfloat16")[2:4] == ms.work(
        1, 1024, 80, 64, 64, 64, 2)
    assert chip_smoke._scan_bwd_bound(2, 1024, 80, 64, 64, 64, 2,
                                      "bfloat16")[2:4] == ms.bwd_work(
        2, 1024, 80, 64, 64, 64, 2)
    assert chip_smoke._mlstm_bound(1, 1000, 4, 1024, 128, None, 2,
                                   "bfloat16")[2:4] == ml.work(
        1, 1000, 4, 1024, 128, False, 2)
    assert chip_smoke._mlstm_bwd_bound(2, 500, 4, 1024, 128, 2,
                                       "bfloat16")[2:4] == ml.bwd_work(
        2, 500, 4, 1024, 128, 2)
    assert chip_smoke._dm_bytes(1025, 4) == dm.work(1025, 4)[1]


@pytest.mark.parametrize("s,causal,window", [
    (1, True, 0), (7, True, 0), (1000, True, 0), (1024, True, 256),
    (300, True, 300), (1000, False, 0), (64, False, 16)])
def test_attention_pairs_count_the_loop(s, causal, window):
    from repro_torch.kernels.analysis import pairs
    want = sum((qi + 1 if causal else s)
               - (max(0, qi - window + 1) if window else 0)
               for qi in range(s))
    assert pairs(s, causal, window) == want


@pytest.mark.parametrize("bs,length,h,hd,qc", [
    (2, 512, 4, 1024, 128), (1, 300, 4, 1024, 128), (2, 1000, 4, 64, 64),
    (1, 17, 2, 8, 16)])
def test_mlstm_bwd_scratch_mirrors_the_c_layout(bs, length, h, hd, qc):
    """``bwd_scratch_floats`` against ``layout`` of csrc/mlstm_bwd.cu,
    transcribed: eleven (B,H,L) vectors, carry, three q x q, two hd x hd,
    two hd, three q x hd per chunk and the scan's partials (ST 256)."""
    nc, bh = -(-length // qc), bs * h
    v, qq, dd = bh * length, bh * nc * qc * qc, bh * nc * hd * hd
    nd, qd = bh * nc * hd, bh * nc * qc * hd
    sizes = [v] * 11 + [bh * nc, qq, qq, qq, dd, dd, nd, nd, qd, qd, qd,
                        bh * nc * ((hd * hd + hd + 255) // 256)]
    assert ml.bwd_scratch_floats(bs, length, h, hd, qc) == sum(sizes)
