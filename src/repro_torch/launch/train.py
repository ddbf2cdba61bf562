"""End-to-end training launcher of the port (the CLI of
``repro.launch.train``, plus ``--ranks`` and ``--device``).

Runs the gang runtime (``runtime.train_loop``) over ``--ranks`` virtual
ranks on one device, ``--pods`` pods of ``ranks / pods``; gradients sync
with the chosen schedule; control points checkpoint every
``--checkpoint-every`` steps into ``--ckpt-dir`` and recover from a
failure injected with ``--fail-at``.  Elastic rescale (``--rescale``)
waits for a later slice of the port and raises if set.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --reduced --ranks 4 --pods 2 --sync compressed --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --ranks 4 --pods 2 --sync compressed --global-batch 8 \\
        --seq-len 1024 --steps 10
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.configs.registry import ARCH_IDS, get_config, reduced_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train_loop import FaabricTrainRuntime, RuntimeConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--sync", default="hierarchical",
                    choices=["hierarchical", "flat", "ring", "compressed"])
    ap.add_argument("--compress-frac", type=float, default=0.05)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--ranks", type=int, default=1,
                    help="virtual ranks (Granules) of the gang on the device")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs without a GPU")
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="/tmp/repro-train")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a failure at this step (recovery demo)")
    ap.add_argument("--rescale", default="",
                    help="step:world pairs, e.g. '20:4,40:8': not ported "
                    "yet (ROADMAP slice (c)); must stay at its default")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch, seed=args.seed)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps)
    rescale = {}
    if args.rescale:
        for pair in args.rescale.split(","):
            s, w = pair.split(":")
            rescale[int(s)] = int(w)
    rt = RuntimeConfig(
        total_steps=args.steps, sync_mode=args.sync,
        compress_frac=args.compress_frac, pods=args.pods,
        checkpoint_every=args.checkpoint_every, ckpt_dir=args.ckpt_dir,
        inject_failures=({args.fail_at: "cli"} if args.fail_at >= 0 else {}),
        rescale_at=rescale)

    runtime = FaabricTrainRuntime(cfg, ocfg, dcfg, rt, ranks=args.ranks,
                                  device=args.device)
    print(f"arch={args.arch} ranks={runtime.ranks} "
          f"mesh={runtime.mesh_shape} sync={args.sync} "
          f"device={runtime.device}")
    t0 = time.time()
    _, out = runtime.run(seed=args.seed)
    dt = time.time() - t0
    losses = out["losses"]
    print(json.dumps({
        "first_loss": round(losses[0], 4), "last_loss": round(losses[-1], 4),
        "steps": len(losses), "recoveries": out["recoveries"],
        "rescales": out["rescales"], "wall_s": round(dt, 1),
        "tokens_per_s": round(args.global_batch * args.seq_len
                              * len(losses) / dt, 1)}, indent=1))
    return out


if __name__ == "__main__":
    main()
