"""Long-context serving with a sub-quadratic arch on the PyTorch port
(xlstm reduced config): prefill a prompt, then decode far beyond it with
O(1) per-token state (the port's twin of
examples/serve_longcontext_ssm.py).

Also demonstrates decode-state snapshotting: a serving Granule migrates
mid-generation (snapshot -> restore) and continues bit-exactly.  Decode
steps run the recurrent cells' plain PyTorch code, no hand-written
kernel.

Run on the GPU (the default) or on the CPU:
    PYTHONPATH=src python examples/serve_longcontext_ssm_torch.py
    PYTHONPATH=src python examples/serve_longcontext_ssm_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import reduced_config
from repro_torch.core import snapshot as snap_mod
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.weights import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduced_config("xlstm-1.3b")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_params(gen, cfg, device=dev)
    serve = M.make_serve_step(cfg)

    b, prompt_len, n_new = 2, 32, 48
    tokens = torch.randint(0, cfg.vocab, (b, prompt_len),
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev)

    def pos(t):
        return torch.full((b, 1), t, dtype=torch.int32, device=dev)

    def argmax(logits):
        return logits[:, 0].argmax(-1)[:, None].to(torch.int32)

    with torch.no_grad():
        # "prefill" by decoding the prompt (state is O(1) in context
        # length)
        states = tf.init_decode_state(cfg, b, prompt_len + n_new,
                                      cfg.torch_dtype(), device=dev)
        for t in range(prompt_len):
            logits, states = serve(params, states, tokens[:, t:t + 1],
                                   pos(t))
        state_bytes = sum(x.numel() * x.element_size()
                          for x in tree_leaves(states))
        print(f"recurrent state: {state_bytes/2**20:.1f} MiB "
              f"(constant in context length)")

        cur = argmax(logits)
        out_a = []
        for t in range(prompt_len, prompt_len + n_new // 2):
            logits, states = serve(params, states, cur, pos(t))
            cur = argmax(logits)
            out_a.append(int(cur[0, 0]))

        # migrate the serving Granule mid-generation: snapshot decode state
        snap = snap_mod.take("serve-job", prompt_len + n_new // 2,
                             {"states": states, "cur": cur})
        restored = snap_mod.restore(snap, dev)
        states2, cur2 = restored["states"], restored["cur"]

        out_b, out_b2 = [], []
        st = states
        for t in range(prompt_len + n_new // 2, prompt_len + n_new):
            logits, st = serve(params, st, cur, pos(t))
            cur = argmax(logits)
            out_b.append(int(cur[0, 0]))
            logits2, states2 = serve(params, states2, cur2, pos(t))
            cur2 = argmax(logits2)
            out_b2.append(int(cur2[0, 0]))

    assert out_b == out_b2, "migrated Granule diverged"
    print(f"generated {len(out_a) + len(out_b)} tokens; "
          f"post-migration continuation bit-exact: {out_b == out_b2}")
    print("sample:", (out_a + out_b)[:12])
    return {"state_mib": state_bytes / 2**20, "state_bytes": state_bytes,
            "generated": len(out_a) + len(out_b),
            "bit_exact": out_b == out_b2, "tokens": out_a + out_b}


if __name__ == "__main__":
    main()
