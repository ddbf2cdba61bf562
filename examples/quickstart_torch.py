"""Quickstart of the PyTorch port: train a reduced llama3.2-1b for 30
steps with the gang runtime (4 virtual ranks in 2 pods, compressed
gradient sync through the collective_codec kernel), then serve it.

Run on the GPU (the default) or on the CPU:
    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs.registry import reduced_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.serve_loop import Request, ServeLoop
from repro_torch.runtime.train_loop import FaabricTrainRuntime, RuntimeConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro-quickstart"))
    args = ap.parse_args(argv)
    cfg = reduced_config("llama3.2-1b")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=0)
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=30)
    rt = RuntimeConfig(total_steps=30, checkpoint_every=10,
                       ckpt_dir=args.ckpt_dir, pods=2,
                       sync_mode="compressed", compress_frac=0.05)

    runtime = FaabricTrainRuntime(cfg, ocfg, dcfg, rt, ranks=4,
                                  device=args.device)
    print(f"training {runtime.ranks} Granules on {runtime.device}; "
          f"mesh={runtime.mesh_shape}")
    state, out = runtime.run(seed=0)
    print(f"loss: {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
          f"over {len(out['losses'])} steps")
    assert out["losses"][-1] < out["losses"][0]

    # serve the trained params
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 16,
                                               dtype=np.int32),
                    max_new_tokens=8) for i in range(2)]
    loop = ServeLoop(cfg, state["params"], max_len=64)
    done = loop.run(reqs)
    print("generated:", done[0].out)
    return {"ranks": runtime.ranks, "mesh": dict(runtime.mesh_shape),
            "losses": out["losses"], "generated": list(done[0].out)}


if __name__ == "__main__":
    main()
