"""launch.hloanalysis on hand-built traces with hand-counted answers:
FLOPs, HBM bytes under the perfect-fusion model, peak live bytes, and the
kernels recorded by the wrappers' analysis route (meta tensors, f32
unless stated: 4 bytes an element)."""
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry as treg
from repro_torch.kernels import analysis
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch.hloanalysis import COLLECTIVES, Recorder
from repro_torch.models import transformer as tf


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def run(fn, *args):
    rec = Recorder()
    rec.arguments(args)
    with rec:
        out = fn(*args)
    rec.outputs(out)
    return rec.analyze()


def test_matmul_chain():
    """mm (material) -> relu (fusable) -> mm: every edge crosses a
    cluster; mm1's and relu's results are written, the output too."""
    m, k, n, p = 64, 32, 48, 16
    a = run(lambda x, w1, w2: torch.relu(x @ w1) @ w2,
            meta(m, k), meta(k, n), meta(n, p))
    assert a["flops"] == 2 * m * k * n + 2 * m * n * p
    assert a["hbm_bytes"] == 4 * (m * k + k * n + n * p + m * p + 4 * m * n)
    args = 4 * (m * k + k * n + n * p)
    assert a["argument_bytes"] == args
    # mm1's result and relu's live together; then relu's and the output
    assert a["peak_bytes"] == args + 4 * max(2 * m * n, m * n + m * p)
    assert all(a[c] == 0 for c in COLLECTIVES) and a["kernels"] == {}


def test_elementwise_chain_is_one_cluster():
    n = 1000
    a = run(lambda x, y, z: ((x + y) * z).exp(), meta(n), meta(n), meta(n))
    assert a["hbm_bytes"] == 4 * (3 * n + n)        # 3 reads, 1 write
    assert a["flops"] == 0


def test_a_view_reads_only_its_region():
    r, c, k = 128, 96, 8
    a = run(lambda x: x[:, :k].exp(), meta(r, c))
    assert a["hbm_bytes"] == 4 * (r * k + r * k)
    assert a["argument_bytes"] == 4 * r * c


def test_gather_reads_and_writes_its_result():
    v, d, n = 1000, 64, 10
    a = run(lambda idx, emb: F.embedding(idx, emb),
            meta(n, dtype=torch.int64), meta(v, d))
    assert a["hbm_bytes"] == 2 * 4 * n * d


def test_gather_feeding_a_product():
    v, d, n, p = 1000, 64, 10, 32
    a = run(lambda idx, emb, w: F.embedding(idx, emb) @ w,
            meta(n, dtype=torch.int64), meta(v, d), meta(d, p))
    # gather 2 n d; mm reads it (n d) and w, writes its output
    assert a["hbm_bytes"] == 4 * (2 * n * d + n * d + d * p + n * p)
    assert a["flops"] == 2 * n * d * p


def test_in_place_update_of_an_argument_is_written_once():
    n = 4096
    a = run(lambda p, g: p.add_(g, alpha=-0.1), meta(n), meta(n))
    assert a["hbm_bytes"] == 4 * 3 * n              # read p, g; write p
    assert a["peak_bytes"] == a["argument_bytes"] == 4 * 2 * n


def test_peak_follows_live_storages():
    def fn():
        x = torch.empty(1000, device="meta")
        y = torch.empty(2000, device="meta")
        del x
        z = torch.empty(500, device="meta")
        return y, z
    rec = Recorder()
    with rec:
        out = fn()
    a = rec.analyze()
    assert a["peak_bytes"] == 4 * 3000
    assert rec.live_bytes == 4 * 2500
    del out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_counted_by_its_work(dtype):
    b, s, h, kv, hd = 2, 256, 8, 2, 64
    q, k, v = (meta(b, s, n, hd, dtype=dtype) for n in (h, kv, kv))
    a = run(lambda q, k, v: fa.flash_attention(q, k, v, causal=True), q, k, v)
    esize = 2 if dtype == torch.bfloat16 else 4
    want = fa.work(b, h, kv, s, hd, True, 0, esize)
    assert a["kernels"] == {"flash_attention": {
        "calls": 1, "launches": 1, "flops": want[0], "bytes": want[1]}}
    assert a["kernel_flops"] == a["flops"] == want[0]
    assert fa.launches == 0                # counted, never launched


def test_no_recorder_no_card_route():
    q = meta(1, 16, 2, 64)
    assert not analysis.traced(q) and not analysis.on_card(q)
    with Recorder():
        assert analysis.traced(q) and analysis.on_card(q)
        cpu = torch.zeros(3)
        assert not analysis.traced(cpu) and not analysis.on_card(cpu)
    assert not analysis.traced(q)


def test_recorder_counts_aten_flops_as_flop_counter():
    """On CPU tensors (the plain route, even inside a recorder) the
    recorder's FLOPs are flop_counter's."""
    cfg = treg.reduced_config("llama3.2-1b")
    gen = torch.Generator().manual_seed(0)
    params = tf.init_params(gen, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            tf.forward(params, tokens, cfg)
        a = run(lambda p, t: tf.forward(p, t, cfg)[0], params, tokens)
    assert a["flops"] == fc.get_total_flops() > 0
    assert a["kernels"] == {}
