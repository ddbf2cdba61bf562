#!/usr/bin/env python3
"""How far zamba2-2.7b's served tokens and logits lie from its own
windowed forward, in f32 and in bf16, at several lengths, with and without
the long_500k window (full width and depth, random weights from a seed,
one H100).  Each case is ``chip_smoke.serve_vs_forward``: one
``ServeLoop`` run of a seeded prompt and 64 greedy tokens, then the
forward over the same tokens.  Prints one ``probe`` JSON line a case.

    python3 long_context_probe.py

Needs a CUDA device (the kernels build with nvcc at first use).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402

# (prompt tokens, new tokens, window): the prompt and the whole sequence
# are multiples of the scan's 64-token chunk
CASES = ((960, 64, 0), (9152, 64, 0), (9152, 64, 4096), (65472, 64, 4096))
KEEP = ("dtype", "prompt", "window", "last_logits_rel", "tokens_equal",
        "tokens_near_tie", "max_gap_rel", "prefill_s", "check_s",
        "serve_peak_gb", "check_peak_gb", "launches")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("long_context_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.models import transformer as tf
    from repro_torch.weights import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs._sh(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]), flush=True)
    cs.build_all(torch)
    mods = {"flash_attention": (fa_ops, "launches"),
            "mamba_scan": (scan_ops, "launches")}
    cfg = get_config("zamba2-2.7b")
    gen = torch.Generator(device="cuda").manual_seed(17)
    with torch.no_grad():
        p16 = tf.init_params(gen, cfg, device="cuda")
    for dname in ("float32", "bfloat16"):
        c = cfg.with_(dtype=dname)
        params = tree_map(lambda t: t.to(c.torch_dtype()), p16)
        for plen, new, window in CASES:
            t0 = time.perf_counter()
            row = cs.serve_vs_forward(torch, c, params, plen, new, window,
                                      mods)
            print("probe", json.dumps({k: row[k] for k in KEEP}),
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
