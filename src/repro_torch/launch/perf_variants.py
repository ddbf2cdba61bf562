"""Config variants of the three chosen cells and their roofline-term
deltas, on H100 constants (PyTorch port of
``repro.launch.perf_variants``; writes results/perf_iterations_torch.json).

Variants per cell:
  baseline        f32 TP reductions
  bf16_tp_reduce  row-parallel partial sums in bf16: on one device it
                  changes nothing (``models.layers.matmul_rp``), so only
                  the modelled TP all-reduce bytes move
"""
from __future__ import annotations

import json
import os
import time

from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun as dr
from repro_torch.launch import hloanalysis

CELLS = [
    ("llama3.2-1b", "train_4k"),
    ("granite-moe-1b-a400m", "train_4k"),
    ("xlstm-1.3b", "train_4k"),
]

OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "results", "perf_iterations_torch.json")


def measure(arch: str, shape_name: str, **overrides):
    """Difference-method analysis with config overrides, on the 16 x 16
    production mesh."""
    shape = SHAPES[shape_name]
    mesh = dr.make_production_mesh()
    cfg = dr.dryrun_config(arch).with_(**overrides)
    m = dr.measure(cfg, shape, shape.global_batch)
    _, args, specs = dr.build_cell(cfg, shape, mesh)
    coll = dr.collectives(cfg, shape, mesh, specs[0]["params"],
                          args[0]["params"])
    coll["collective_bytes"] = sum(coll[k] for k in hloanalysis.COLLECTIVES)
    coll["hbm_bytes"] = m["hbm_bytes"] / mesh.size
    return dr.roofline({"flops": m["flops"] / mesh.size}, coll, cfg, shape,
                       mesh.size)


def main():
    results = {}
    for arch, shape in CELLS:
        for name, overrides in (("baseline", {}),
                                ("bf16_tp_reduce", {"bf16_tp_reduce": True})):
            t0 = time.time()
            rl = measure(arch, shape, **overrides)
            key = f"{arch}/{shape}/{name}"
            results[key] = {
                "terms_s": rl["terms_s"],
                "bottleneck": rl["bottleneck"],
                "roofline_fraction": rl["roofline_fraction"],
                "collective_bytes": rl["per_device"]["collective_bytes"],
                "measure_s": round(time.time() - t0, 1),
            }
            print(key, json.dumps(results[key]))
    os.makedirs(os.path.dirname(os.path.abspath(OUT)), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
