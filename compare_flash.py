#!/usr/bin/env python3
"""Time one kernel of two checkouts on one GPU, in turns.

    python3 compare_flash.py [--kernel flash|moe_gmm|moe_gmm_bwd|moe_step|
                              mlstm|mamba_scan|mlstm_bwd|mamba_scan_bwd|
                              hybrid_step] OLD_CHECKOUT [NEW_CHECKOUT]

NEW_CHECKOUT defaults to this script's own directory.  Both packages are
named ``repro_torch``, so each checkout runs in a process of its own, in
the order old, new, new, old (two calls of one card are compared only
inside one run).  Each process builds its checkout's kernels into that
checkout's ``build/`` and times them by CUDA events at the main paths'
shapes, bf16.

``flash`` (the default): causal, H 32, KV 8: the forward at B 1, S 1024,
hd 64 (llama3.2-1b's prefill) and hd 128 (phi3.5-moe's), and the backward
at B 2, S 1024, hd 64 (the training micro-batch); beside each, one call
of ``scaled_dot_product_attention`` (forward, or autograd of it), which
the port never calls.

``moe_gmm``: the SwiGLU expert FFN at granite-moe-1b-a400m's (E 32, d
1024, ff 512) M 320 and M 8 and phi3.5-moe's (E 16, d 4096, ff 6400) M
160 and M 2 (a 1024-token prefill and an 8-lane decode step); beside
each, the cuBLAS composition of the same FFN (``chip_smoke._gmm_cublas``:
h rounded to bf16, several calls), effective GB/s and TFLOP/s.

``moe_gmm_bwd``: the expert FFN's backward at granite-moe-1b-a400m's
training shape (E 32, M 1280, d 1024, ff 512), SwiGLU and gelu, and at
phi3.5-moe's prefill shape (E 16, M 160, d 4096, ff 6400), SwiGLU; beside
each its bound and the device time of each of its launches
(``passes_ms``).  ``moe_step``: one warm training step of granite-moe-
1b-a400m as chip_smoke's ``train-family-moe`` runs it (full width and
depth, 2 ranks, global batch 8 x 1024, hierarchical sync): the median of
five steps' wall time, and one step under torch.profiler
(``chip_smoke.profile_phase``: device time by kernel kind, idle share).

``mlstm``: the chunkwise mLSTM at xlstm-1.3b's shapes (H 4, hd 1024,
chunk 128, the model's forget gates): B 1 at L 1024 (a prefill), L 1000
(ragged) and L 300 from an initial state, and B 4 at L 512 (the fixed
batch).  ``mamba_scan``: the SSD scan at zamba2-2.7b's (H 80, P 64, N 64,
chunk 64, a = -(1..80)): B 1 at L 1024 and 256, B 4 at L 512.  No PyTorch
call computes either function.  Each of their rows also gives the device
time of each pass (``passes_ms``, torch.profiler).

``mamba_scan_bwd`` and ``mlstm_bwd``: the backward kernels at the training
shapes of chip_smoke's ``kernel-check`` rows (zamba2-2.7b: rank batch 2 x
1024, H 80, P = N = 64, chunk 64, the model's gates; xlstm-1.3b: rank
batch 2 x 512, 4 heads of hd 1024, chunk 128, slow forget gates), bf16,
each beside its bound, autograd of its plain version and the device time
of each pass (``passes_ms``).  ``hybrid_step``: one warm training step of
zamba2-2.7b as chip_smoke's ``train-family-hybrid`` runs it (full width
and depth, 2 ranks, global batch 4 x 1024), as ``moe_step`` times
granite's.

Prints the card's name and power limit (``nvidia-smi``), a
``<kernel>-compare`` JSON line per process and a
``<kernel>-compare-summary`` line: each checkout's best time per shape.
Exits non-zero without a GPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = [("fwd", 1, 1024, 64), ("fwd", 1, 1024, 128), ("bwd", 2, 1024, 64)]
# (arch, E, M, d, ff)
GMM_SHAPES = [("granite", 32, 320, 1024, 512), ("granite", 32, 8, 1024, 512),
              ("phi3.5", 16, 160, 4096, 6400), ("phi3.5", 16, 2, 4096, 6400)]
# (B, L, state) at xlstm-1.3b's H 4, hd 1024; (B, L) at zamba2-2.7b's
ML_SHAPES = [(1, 1024, False), (1, 1000, False), (4, 512, False),
             (1, 300, True)]
SCAN_SHAPES = [(1, 1024), (1, 256), (4, 512)]
# (arch, E, M, d, ff, act) of the moe_gmm backward
GMM_BWD_SHAPES = [("granite", 32, 1280, 1024, 512, "silu"),
                  ("granite", 32, 1280, 1024, 512, "gelu"),
                  ("phi3.5", 16, 160, 4096, 6400, "silu")]
KERNELS = ("flash", "moe_gmm", "moe_gmm_bwd", "moe_step", "mlstm",
           "mamba_scan", "mlstm_bwd", "mamba_scan_bwd", "hybrid_step")


def gmm_rows(torch, cs):
    from repro_torch.kernels.moe_gmm import ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for arch, e, m, d, ff in GMM_SHAPES:
        x = torch.randn((e, m, d), generator=gen, device="cuda").bfloat16()
        w1, w3 = (torch.randn((e, d, ff), generator=gen, device="cuda")
                  .mul_(0.02).bfloat16() for _ in range(2))
        w2 = torch.randn((e, ff, d), generator=gen, device="cuda").mul_(
            0.02).bfloat16()
        ms = cs._time_ms(lambda: ops._launch(x, w1, w2, w3, "silu"))
        lib_ms = cs._time_ms(lambda: cs._gmm_cublas(torch, x, w1, w2, w3,
                                                    "silu"))
        bound_ms, bound_by, flops, nbytes, _ = cs._gmm_bound(
            e, m, d, ff, "silu", "bfloat16", 2)
        rows.append({"key": f"{arch} M{m}", "E": e, "M": m, "d": d,
                     "ff": ff, "ms": ms, "tflops": flops / (ms * 1e-3) / 1e12,
                     "gbytes_per_s": nbytes / ms * 1e-6,
                     "cublas_composition_ms": lib_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by})
        del x, w1, w2, w3
        torch.cuda.empty_cache()
    return rows


def gmm_bwd_rows(torch, cs):
    from repro_torch.kernels.moe_gmm import ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for arch, e, m, d, ff, act in GMM_BWD_SHAPES:
        x, dy = (torch.randn((e, m, d), generator=gen, device="cuda")
                 .bfloat16() for _ in range(2))
        w1, w3 = (torch.randn((e, d, ff), generator=gen, device="cuda")
                  .mul_(0.02).bfloat16() for _ in range(2))
        w2 = torch.randn((e, ff, d), generator=gen, device="cuda").mul_(
            0.02).bfloat16()

        def fn():
            return ops._launch_bwd(x, w1, w2, w3, dy, act)
        ms = cs._time_ms(fn, iters=10)
        bound_ms, bound_by, flops, _ = cs._gmm_bwd_bound(
            e, m, d, ff, act, "bfloat16", 2)
        rows.append({"key": f"{arch} M{m} {act}", "E": e, "M": m, "d": d,
                     "ff": ff, "act": act, "ms": ms,
                     "tflops": flops / (ms * 1e-3) / 1e12,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "passes_ms": cs.pass_ms(torch, fn, iters=5)})
        del x, dy, w1, w2, w3
    return rows


def moe_step_rows(torch, cs, tag="moe"):
    import time

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import (FaabricTrainRuntime,
                                                RuntimeConfig,
                                                family_batch_fn)

    arch, _, _, ranks, gb, seq, steps, lr, _ = next(
        f for f in cs.TRAIN_FAMILIES if f[1] == tag)
    cfg = get_config(arch)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb)
    rt = RuntimeConfig(total_steps=steps, checkpoint_every=0,
                       ckpt_dir=os.path.join(HERE, "build", "compare_ckpt"))
    runtime = FaabricTrainRuntime(
        cfg, AdamWConfig(lr=lr, warmup_steps=steps // 2, total_steps=steps),
        dcfg, rt, ranks=ranks, device="cuda")
    run = {"state": runtime.init_state(seed=0)}
    runtime._build(run["state"])
    run["resid"] = runtime._init_resid(run["state"])
    batch = {k: torch.as_tensor(v).to("cuda")
             for k, v in family_batch_fn(cfg)(dcfg, 0).items()}

    def step():
        run["state"], metrics, run["resid"] = runtime._step_fn(
            run["state"], batch, run["resid"])
        return float(metrics["loss"])
    for _ in range(2):          # warm
        step()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    prof = cs.profile_phase(torch, f"{tag}_train_step",
                            lambda: (step(), 1)[1])
    runtime.release()
    return [{"key": f"{arch} step", "ms": sorted(times)[2] * 1e3,
             "step_ms": [t * 1e3 for t in times], "ranks": ranks,
             "batch": [gb, seq], "profile": prof}]


def mlstm_rows(torch, cs):
    from repro_torch.kernels.mlstm import ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    h, hd, chunk = 4, 1024, 128
    rows = []
    for b, length, with_state in ML_SHAPES:
        q, k, v = (torch.randn((b, length, h, hd), generator=gen,
                               device="cuda").bfloat16() for _ in range(3))
        li = torch.randn((b, length, h), generator=gen, device="cuda") - 1
        lf = torch.nn.functional.logsigmoid(
            torch.randn((b, length, h), generator=gen, device="cuda") + 3)
        st = None
        if with_state:
            st = (torch.randn((b, h, hd, hd), generator=gen,
                              device="cuda") * 0.3,
                  torch.randn((b, h, hd), generator=gen, device="cuda") * .3,
                  torch.randn((b, h), generator=gen, device="cuda"))
        def fn():
            return ops._launch(q, k, v, li, lf, st, chunk)
        ms = cs._time_ms(fn, iters=10)
        bound_ms, bound_by, flops, nbytes, _ = cs._mlstm_bound(
            b, length, h, hd, min(chunk, length), with_state, 2, "bfloat16")
        rows.append({"key": f"B{b} L{length}" + (" state" if with_state
                                                  else ""),
                     "B": b, "L": length, "state": with_state, "ms": ms,
                     "tflops": flops / (ms * 1e-3) / 1e12,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "passes_ms": cs.pass_ms(torch, fn)})
    return rows


def scan_rows(torch, cs):
    from repro_torch.kernels.mamba_scan import ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    h, p, n, chunk = 80, 64, 64, 64
    a = -torch.arange(1, h + 1, dtype=torch.float32, device="cuda")
    rows = []
    for b, length in SCAN_SHAPES:
        x = (torch.randn((b, length, h, p), generator=gen, device="cuda")
             * 0.5).bfloat16()
        dt = torch.nn.functional.softplus(
            torch.randn((b, length, h), generator=gen, device="cuda"))
        bb, cc = ((torch.randn((b, length, n), generator=gen, device="cuda")
                   * 0.5).bfloat16() for _ in range(2))
        def fn():
            return ops._launch(x, dt, a, bb, cc, chunk)
        ms = cs._time_ms(fn)
        bound_ms, bound_by, flops, nbytes, _ = cs._scan_bound(
            b, length, h, p, n, chunk, 2, "bfloat16")
        rows.append({"key": f"B{b} L{length}", "B": b, "L": length,
                     "ms": ms, "gbytes_per_s": nbytes / ms * 1e-6,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "passes_ms": cs.pass_ms(torch, fn)})
    return rows


def scan_bwd_rows(torch, cs):
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.mamba_scan import ref

    b, length, h, p, n, chunk = 2, 1024, 80, 64, 64, 64
    ins = ref.scan_inputs(b, length, h, p, n, gates="model",
                          dtype=torch.bfloat16, seed=24, device="cuda")

    def fn():
        return ops._launch_bwd(*ins, None, chunk)
    ms = cs._time_ms(fn, iters=10)
    plain_ms = cs._time_ms(lambda: ref.ssd_chunked_grads(
        *ins[:5], chunk, ins[5]), iters=3, warmup=1)
    bound_ms, bound_by, flops, nbytes, _ = cs._scan_bwd_bound(
        b, length, h, p, n, chunk, 2, "bfloat16")
    return [{"key": f"B{b} L{length}", "B": b, "L": length, "H": h,
             "ms": ms, "plain_ms": plain_ms,
             "tflops": flops / (ms * 1e-3) / 1e12, "bound_ms": bound_ms,
             "bound_by": bound_by, "passes_ms": cs.pass_ms(torch, fn,
                                                           iters=5)}]


def mlstm_bwd_rows(torch, cs):
    from repro_torch.kernels.mlstm import ops
    from repro_torch.kernels.mlstm import ref

    b, length, h, hd, chunk = 2, 512, 4, 1024, 128
    ins = ref.grad_inputs(b, length, h, hd, gates="slow",
                          dtype=torch.bfloat16, seed=25, device="cuda")

    def fn():
        return ops._launch_bwd(*ins, chunk)
    ms = cs._time_ms(fn, iters=10)
    plain_ms = cs._time_ms(lambda: ref.mlstm_chunked_grads(
        *ins[:5], chunk, ins[5]), iters=3, warmup=1)
    bound_ms, bound_by, flops, nbytes, _ = cs._mlstm_bwd_bound(
        b, length, h, hd, chunk, 2, "bfloat16")
    return [{"key": f"B{b} L{length}", "B": b, "L": length, "H": h,
             "hd": hd, "ms": ms, "plain_ms": plain_ms,
             "tflops": flops / (ms * 1e-3) / 1e12, "bound_ms": bound_ms,
             "bound_by": bound_by, "passes_ms": cs.pass_ms(torch, fn,
                                                           iters=5)}]


def child(tree: str, kernel: str) -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs          # timing and bound helpers of this tree
    if not torch.cuda.is_available():
        print("compare_flash: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mlstm import ops as ml_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops

    for mod in (ops, gmm_ops, ml_ops, scan_ops):
        assert mod.__file__.startswith(os.path.abspath(tree)), mod.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    other = {"moe_gmm": gmm_rows, "moe_gmm_bwd": gmm_bwd_rows,
             "moe_step": moe_step_rows, "mlstm": mlstm_rows,
             "mamba_scan": scan_rows, "mamba_scan_bwd": scan_bwd_rows,
             "mlstm_bwd": mlstm_bwd_rows,
             "hybrid_step": lambda t, c: moe_step_rows(t, c, "hybrid")}
    if kernel in other:
        print(f"{kernel}-compare " + json.dumps({
            "tree": os.path.abspath(tree),
            "device": torch.cuda.get_device_name(0),
            "rows": other[kernel](torch, cs)}), flush=True)
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    h, kv = 32, 8
    rows = []
    for kind, b, s, hd in SHAPES:
        qt, kt, vt = (torch.randn((b, n, s, hd), generator=gen,
                                  device="cuda").bfloat16()
                      for n in (h, kv, kv))
        scale = hd ** -0.5
        if kind == "fwd":
            ms = cs._time_ms(lambda: ops._launch(qt, kt, vt, causal=True,
                                                 window=0, scale=scale))
            lib_ms = cs._time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            bound_ms, bound_by, flops = cs._bound(b, h, kv, s, hd, True, 0,
                                                  "bfloat16", 2)
        else:
            dot = torch.randn(qt.shape, generator=gen,
                              device="cuda").bfloat16()
            # (out, lse), or (out, lse, o32) where the backward takes the
            # forward's output in f32
            res = ops._launch(qt, kt, vt, causal=True, window=0,
                              scale=scale, with_lse=True)
            o, lse = res[2 if len(res) == 3 else 0], res[1]
            ms = cs._time_ms(lambda: ops._launch_bwd(
                qt, kt, vt, o, lse, dot, causal=True, window=0,
                scale=scale), iters=10)
            leaves = tuple(t.clone().requires_grad_() for t in (qt, kt, vt))
            so = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                enable_gqa=True)
            lib_ms = cs._time_ms(lambda: torch.autograd.grad(
                so, leaves, dot, retain_graph=True), iters=10)
            bound_ms, bound_by, flops = cs._bwd_bound(b, h, kv, s, hd, 0,
                                                      "bfloat16", 2)
        rows.append({"key": f"{kind} B{b} S{s} hd{hd}", "kind": kind,
                     "B": b, "S": s, "hd": hd, "ms": ms,
                     "tflops": flops / (ms * 1e-3) / 1e12,
                     "library_ms": lib_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by})
    print("flash-compare " + json.dumps({
        "tree": os.path.abspath(tree), "device": torch.cuda.get_device_name(0),
        "rows": rows}), flush=True)
    return 0


def main(argv) -> int:
    if len(argv) >= 3 and argv[0] == "--child":
        return child(argv[1], argv[2])
    kernel = "flash"
    if len(argv) >= 2 and argv[0] == "--kernel":
        kernel, argv = argv[1], argv[2:]
    if not argv or kernel not in KERNELS:
        print(__doc__, file=sys.stderr)
        return 2
    old = os.path.abspath(argv[0])
    new = os.path.abspath(argv[1] if len(argv) > 1 else HERE)
    import chip_smoke as cs
    print("card " + cs._sh(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"]), flush=True)
    best = {}
    for tag, tree in (("old", old), ("new", new), ("new", new),
                      ("old", old)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", tree, kernel], capture_output=True,
                              text=True, cwd=HERE, timeout=600)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            return proc.returncode
        line = next(x for x in proc.stdout.splitlines()
                    if x.startswith(f"{kernel}-compare "))
        print(f"{tag} {line}", flush=True)
        for r in json.loads(line.split(" ", 1)[1])["rows"]:
            key = f"{tag} {r['key']}"
            best[key] = min(best.get(key, float("inf")), r["ms"])
    print(f"{kernel}-compare-summary " + json.dumps(best), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
