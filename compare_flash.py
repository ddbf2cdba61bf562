#!/usr/bin/env python3
"""Time one kernel of two checkouts on one GPU, in turns.

    python3 compare_flash.py [--kernel flash|moe_gmm] OLD_CHECKOUT [NEW_CHECKOUT]

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

Prints a ``<kernel>-compare`` JSON line per process and a
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
KERNELS = ("flash", "moe_gmm")


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


def child(tree: str, kernel: str) -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs          # timing and bound helpers of this tree
    if not torch.cuda.is_available():
        print("compare_flash: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops

    for mod in (ops, gmm_ops):
        assert mod.__file__.startswith(os.path.abspath(tree)), mod.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    if kernel == "moe_gmm":
        print("moe_gmm-compare " + json.dumps({
            "tree": os.path.abspath(tree),
            "device": torch.cuda.get_device_name(0),
            "rows": gmm_rows(torch, cs)}), flush=True)
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
