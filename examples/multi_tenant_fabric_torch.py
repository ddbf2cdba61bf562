"""Multi-tenant fabric end-to-end on the PyTorch port: a training gang and
a serving gang share one device pool, interleave step-by-step, and a
high-priority arrival preempts the trainer — which checkpoints, waits,
and resumes bit-exactly (the port's twin of
examples/multi_tenant_fabric.py: 8 virtual devices, reduced llama3.2-1b;
on the GPU every step runs the flash kernels).

Run on the GPU (the default) or on the CPU:
    PYTHONPATH=src python examples/multi_tenant_fabric_torch.py
    PYTHONPATH=src python examples/multi_tenant_fabric_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs.registry import reduced_config
from repro_torch.core.devices import virtual_devices
from repro_torch.core.fabric import Fabric
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.gang_workloads import ServeWorkload, TrainWorkload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = reduced_config("llama3.2-1b").with_(n_layers=1, vocab=128)
    dcfg = DataConfig(vocab=128, seq_len=8, global_batch=8, seed=0)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)

    fabric = Fabric(devices=virtual_devices(8, args.device),
                    chips_per_host=2)
    print(f"fabric: {len(fabric.devices)} chips on "
          f"{fabric.engine.hosts} hosts")

    # tenant 1: a training gang on 6 chips; tenant 2: a serving gang on 2
    train = fabric.allocate("train0", 6, priority=0)
    serve = fabric.allocate("serve0", 2, priority=1)
    twl = TrainWorkload(cfg, ocfg, dcfg, total_steps=6)
    twl.bind(train)
    twl.init_state(train)
    swl = ServeWorkload(cfg, prompt_len=8, new_tokens=4, batch=2,
                        max_len=16)
    swl.bind(serve)
    swl.init_state(serve)

    # interleave both tenants; after 3 train steps a high-priority gang
    # arrives and does not fit -> the engine plans a preemption
    for _ in range(3):
        twl.run_step(train)
        swl.run_step(serve)
    victims = fabric.preemption_plan(6, priority=5)
    print("high-priority arrival (6 chips): evict", victims)
    snap = train.preempt(twl.state, twl.steps_done)
    print(f"  checkpointed train0 at step {snap.step} "
          f"({snap.nbytes/1e6:.1f} MB, fp {snap.fingerprint})")

    hi = fabric.allocate("hi0", 6, priority=5)
    hwl = TrainWorkload(cfg, ocfg, dcfg, total_steps=2)
    hwl.bind(hi)
    hwl.init_state(hi)
    while not (hwl.done and swl.done):
        if not hwl.done:
            hwl.run_step(hi)
        if not swl.done:
            swl.run_step(serve)
    hi.release()
    print("  high-priority gang done:", [round(l, 4) for l in hwl.losses])

    state, step = train.resume()       # fingerprint-verified restore
    twl.state = state
    twl.bind(train)
    while not twl.done:
        twl.run_step(train)
    print(f"train0 resumed at step {step}, losses:",
          [round(l, 4) for l in twl.losses])
    print("serve0 outputs:", [r.out for r in swl.requests])

    train.release()
    serve.release()
    assert fabric.idle_chips() == fabric.engine.total_chips
    # reference: the same 6 steps uninterrupted match bit-for-bit
    ref_h = fabric.allocate("ref", 6)
    ref = TrainWorkload(cfg, ocfg, dcfg, total_steps=6)
    ref.bind(ref_h)
    ref.init_state(ref_h)
    while not ref.done:
        ref.run_step(ref_h)
    ref_h.release()
    np.testing.assert_allclose(ref.losses, twl.losses, atol=1e-6)
    print("preempted-and-resumed losses match uninterrupted run ✓")
    return {"chips": len(fabric.devices), "hosts": fabric.engine.hosts,
            "evict": list(victims), "checkpoint_step": snap.step,
            "resume_step": step, "losses": list(twl.losses),
            "ref_losses": list(ref.losses),
            "serve_outputs": [list(r.out) for r in swl.requests]}


if __name__ == "__main__":
    main()
