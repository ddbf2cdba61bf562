"""Fault tolerance + elasticity end-to-end on the PyTorch port: a training
gang survives an injected node failure (gang restart from snapshot,
bit-exact) and then shrinks from 8 to 4 Granules at a control point
without perturbing the loss trajectory (the port's twin of
examples/fault_tolerant_elastic.py; reduced granite-moe-1b-a400m, so on
the GPU its steps run the moe_gmm and flash kernels and their
backwards).

Run on the GPU (the default) or on the CPU:
    PYTHONPATH=src python examples/fault_tolerant_elastic_torch.py
    PYTHONPATH=src python examples/fault_tolerant_elastic_torch.py --device cpu
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs.registry import reduced_config
from repro_torch.core.devices import virtual_devices
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train_loop import FaabricTrainRuntime, RuntimeConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro-fte-torch"))
    args = ap.parse_args(argv)
    root = args.ckpt_dir
    shutil.rmtree(root, ignore_errors=True)
    cfg = reduced_config("granite-moe-1b-a400m")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=0)
    ocfg = AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=24)

    world = len(virtual_devices(8, args.device))
    print(f"devices: {world}")
    # reference run: no faults
    ref = FaabricTrainRuntime(cfg, ocfg, dcfg, RuntimeConfig(
        total_steps=24, checkpoint_every=6,
        ckpt_dir=os.path.join(root, "ref")), ranks=world,
        device=args.device).run(seed=0)[1]

    # chaos run: node failure at step 8, elastic shrink at step 16
    chaos_rt = RuntimeConfig(
        total_steps=24, checkpoint_every=6,
        ckpt_dir=os.path.join(root, "chaos"),
        inject_failures={8: "simulated host loss"},
        rescale_at={16: max(world // 2, 1)})
    chaos = FaabricTrainRuntime(cfg, ocfg, dcfg, chaos_rt, ranks=world,
                                device=args.device).run(seed=0)[1]

    print(f"recoveries={chaos['recoveries']} rescales={chaos['rescales']}")
    print(f"ref   losses: {[round(l, 3) for l in ref['losses'][:6]]} ...")
    print(f"chaos losses: {[round(l, 3) for l in chaos['losses'][:6]]} ...")
    # exact up to the rescale point (recovery is bit-exact) ...
    np.testing.assert_allclose(ref["losses"][:16], chaos["losses"][:16],
                               atol=1e-4)
    # ... and statistically unchanged after it: MoE capacity grouping is
    # per-Granule, so a different world size legitimately drops different
    # tokens (same effect as re-bucketing EP groups on a real resize).
    np.testing.assert_allclose(ref["losses"][16:], chaos["losses"][16:],
                               atol=0.25)
    print("OK: recovery bit-exact; rescale loss-invariant up to MoE "
          "capacity regrouping")
    return {"devices": world, "recoveries": chaos["recoveries"],
            "rescales": chaos["rescales"], "ref_losses": ref["losses"],
            "chaos_losses": chaos["losses"],
            "worlds": [e["world"] for e in chaos["log"]]}


if __name__ == "__main__":
    main()
