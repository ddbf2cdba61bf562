"""Multi-pod dry-run of the port: trace every (arch x shape x mesh) cell
on the meta device and model it on a mesh of H100 cards (PyTorch port of
``repro.launch.dryrun``).

For each cell this module builds the step function the shape dictates
(train_step / prefill_step / serve_step) from ``models.model``'s specs,
assigns the production partition specs (``models.shardings``) and traces
the step with ``launch.hloanalysis.Recorder``, in which meta tensors take
the card's routes: every hand-written kernel is counted by its own
``work()`` (``kernels.analysis``), every other op by
``torch.utils.flop_counter``'s formulas.  Nothing is compiled or run; no
GPU is needed.  Per device on the mesh:

  * argument bytes: exact, each leaf's bytes over its spec's shards;
  * FLOPs and HBM bytes: the trace's totals at the global batch over the
    mesh's size (the work split evenly: an estimate);
  * temporaries: the trace's peak live bytes less its arguments, at the
    per-device batch (micro-batched by ``GRAD_ACCUM`` for train_4k), its
    gradients (the f32 accumulator when micro-batched) counted per
    device from ``grad_pspecs`` and every other activation whole, so an
    upper bound where the ``model`` axis would shard it;
  * collective bytes: a stated model of the specs (``collectives``), as
    estimated as the JAX package's own HLO analysis.

On a one-card mesh (``make_host_mesh((1, 1), ("data", "model"))``)
nothing is split or modelled but the fusion of the HBM bytes;
``chip_smoke.py`` holds the kernel calls, the peak memory and the bound
of such steps against the same steps on the card.  The difference method (1 and 2
periods) gives the full depth, and for the xLSTM family, whose sLSTM is
a token loop, two lengths give the full sequence (every block is linear
in it).  Results go to ``results/dryrun_torch/<cell>.json``; ``--all``
fans cells out to subprocesses.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                      cell_applicable)
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import hloanalysis
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import model as model_mod
from repro_torch.models import shardings as sh
from repro_torch.optim.adamw import AdamWConfig

# H100 SXM per-card constants (roofline denominators; NVIDIA data sheet)
PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
HBM_GB = 80.0                # device memory, GB (2^30 bytes, as reported)
LINK_BW = 50e9               # bytes/s per card: 400 Gb/s NDR InfiniBand,
#                              the slow link a 16-wide model axis crosses

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# Gradient accumulation per arch for the train_4k shape: keeps per-device
# activations within the card's memory (the JAX package's table).
GRAD_ACCUM = {
    "phi3.5-moe-42b-a6.6b": 4, "glm4-9b": 4, "llama-3.2-vision-11b": 4,
    "minitron-4b": 2, "llama3.2-3b": 2, "zamba2-2.7b": 4, "xlstm-1.3b": 4,
    "llama3.2-1b": 2, "granite-moe-1b-a400m": 2, "whisper-small": 2,
}
# the xLSTM family's traces run at these lengths (multiples of its chunk)
SEQ_PROBES = (128, 256)
_ONE_CARD = make_host_mesh((1, 1), ("data", "model"))


def dryrun_config(arch: str, deploy: bool = False) -> ArchConfig:
    """The JAX dry-run's overrides: remat on; FSDP when TP-only optimizer
    state would exceed ~2 GB a card.  ``scan_layers`` and ``deploy`` are
    kept for parity; the port's layers are a Python loop either way."""
    cfg = get_config(arch)
    big = model_mod.count_params(cfg) * 16 / 256 > 2e9
    return cfg.with_(scan_layers=deploy, remat=True, fsdp=big,
                     deploy=deploy)


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               grad_accum: int = 1):
    """Returns (fn, args, in_specs) for this cell: ``args`` are meta
    tensors (``models.model``'s specs), ``in_specs`` their partition
    specs on ``mesh``."""
    ocfg = AdamWConfig()
    if shape.kind == "train":
        gspecs = sh.param_pspecs(cfg, model_mod.param_specs(cfg), mesh)
        state = model_mod.train_state_specs(cfg, ocfg)
        batch = model_mod.batch_specs(cfg, shape)
        bspecs = sh.batch_pspecs(cfg, batch, mesh)
        fn = model_mod.make_train_step(cfg, ocfg, grad_accum=grad_accum,
                                       grad_pspecs=gspecs,
                                       batch_pspecs=bspecs)
        return fn, (state, batch), (sh.state_pspecs(cfg, state, mesh),
                                    bspecs)
    if shape.kind == "prefill":
        fn = model_mod.make_prefill_step(cfg)
        params = model_mod.param_specs(cfg)
        batch = model_mod.batch_specs(cfg, shape, with_labels=False)
        return fn, (params, batch), (sh.param_pspecs(cfg, params, mesh),
                                     sh.batch_pspecs(cfg, batch, mesh))
    window = model_mod.decode_window(cfg, shape)
    fn = model_mod.make_serve_step(cfg, window=window)
    params = model_mod.param_specs(cfg)
    states = model_mod.decode_state_specs(cfg, shape)
    inputs = model_mod.decode_input_specs(cfg, shape)
    ispecs = sh.batch_pspecs(cfg, inputs, mesh)
    return fn, (params, states, inputs["tokens"], inputs["positions"]), (
        sh.param_pspecs(cfg, params, mesh),
        sh.decode_state_pspecs(cfg, states, mesh), ispecs["tokens"],
        ispecs["positions"])


def trace(fn, args, train: bool) -> Dict[str, Any]:
    """``fn(*args)`` traced once by a ``Recorder``: its analysis."""
    rec = hloanalysis.Recorder()
    rec.arguments(args)
    with rec, torch.set_grad_enabled(train):
        out = fn(*args)
    rec.outputs(out)
    return rec.analyze()


def _shards(spec, mesh) -> int:
    """How many pieces ``spec`` cuts its leaf into on ``mesh``."""
    n = 1
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                n *= mesh.shape.get(a, 1)
    return n


def per_device_bytes(tree, specs, mesh) -> int:
    """Bytes of ``tree``'s tensor leaves on one device under ``specs``."""
    return sum(t.numel() * t.element_size() // _shards(s, mesh)
               for (_, t), s in zip(sh.leaves_with_keys(tree),
                                    sh.spec_leaves(specs))
               if isinstance(t, torch.Tensor))


def collectives(cfg: ArchConfig, shape: ShapeConfig, mesh, pspecs,
                params) -> Dict[str, int]:
    """Modelled per-device collective bytes of one step, by kind (each
    collective's result, as the JAX analysis counts it):

    * TP all-reduce (``model`` > 1): the (tokens, d_model) output of every
      row-parallel weight use (a leaf whose input dim is on ``model``: wo,
      w2, out_proj, down, a vocab-sharded embedding), f32, or bf16 under
      ``bf16_tp_reduce``; a training step pays it in the forward, again
      in the remat recompute, and once for the column-parallel inputs'
      gradients in the backward.
    * TP all-to-all: an expert-parallel MoE layer's dispatch and combine,
      (tokens, top_k x capacity_factor, d_model) in the params' dtype, the
      same passes.
    * FSDP (a ``data`` entry in a param's spec): the param gathered per
      pass (forward, and the backward's regather when training) and its
      gradient reduce-scattered.
    * DP gradient all-reduce over the dp axes a gradient is not already
      scattered over, and the updated params' all-gather of ZeRO-1
      (moments sharded over ``data``).
    """
    out = dict.fromkeys(hloanalysis.COLLECTIVES, 0)
    tp = mesh.shape.get("model", 1)
    dpx = sh.dp_axes(mesh)
    dp = math.prod(mesh.shape[a] for a in dpx)
    b = shape.global_batch
    tokens = (b // dp if b % dp == 0 else b) * (
        shape.seq_len if shape.kind != "decode" else 1)
    train = shape.kind == "train"
    passes = (3 if cfg.remat else 2) if train else 1
    esize = torch.empty((), dtype=cfg.torch_dtype()).element_size()
    leaves = list(zip(sh.leaves_with_keys(params), sh.spec_leaves(pspecs)))
    if tp > 1:
        uses = 0
        for (keys, leaf), spec in leaves:
            stacked = keys[0] in ("blocks", "encoder")
            dims = spec[1:] if stacked else spec
            reps = leaf.shape[0] if stacked else 1
            if keys[0] == "shared":
                reps = cfg.n_periods()
            if len(dims) == 2 and dims[0] == "model" and keys[-1] in (
                    "wo", "w2", "out_proj", "down", "embed"):
                uses += reps
            if keys[-1] == "w1" and "moe" in keys and dims[0] == "model":
                moe_bytes = int(tokens * cfg.top_k * cfg.capacity_factor
                                * cfg.d_model * esize)
                out["all-to-all"] += 2 * reps * passes * moe_bytes
        act = tokens * cfg.d_model * (2 if cfg.bf16_tp_reduce else 4)
        out["all-reduce"] += uses * passes * act
    for (_, leaf), spec in leaves:
        full = leaf.numel() * leaf.element_size()
        shard = full // _shards(spec, mesh)
        if "data" in spec:
            out["all-gather"] += (2 if train else 1) * shard * \
                mesh.shape["data"]
            if train:
                out["reduce-scatter"] += shard
        if train and dp > 1:
            rest = math.prod(mesh.shape[a] for a in dpx if a not in spec)
            if rest > 1:
                out["all-reduce"] += shard
            if "data" not in spec and "data" in mesh.shape:
                out["all-gather"] += shard      # ZeRO-1: new params
    return out


def _extrap(a, b, n: float):
    """a + n (b - a) over numbers and nested dicts of them."""
    if isinstance(a, dict):
        return {k: _extrap(a[k], b[k], n) for k in a}
    return a + n * (b - a)


def measure(cfg: ArchConfig, shape: ShapeConfig, batch: int,
            grad_accum: int = 1) -> Dict[str, Any]:
    """The analysis of the full-depth, full-length step at ``batch``
    sequences: traces at 1 and 2 periods (and, for the xLSTM family, at
    two lengths), extrapolated."""
    period_len = len(cfg.period())
    n_per = cfg.n_periods()
    train = shape.kind == "train"

    def at(k: int, seq: int):
        cfg_k = cfg.with_(n_layers=period_len * k)
        s = dataclasses.replace(shape, global_batch=batch, seq_len=seq)
        fn, args, _ = build_cell(cfg_k, s, _ONE_CARD, grad_accum)
        return trace(fn, args, train)

    def depth(seq: int):
        m1, m2 = at(1, seq), at(2, seq)
        return _extrap(m1, m2, n_per - 1), (m1, m2)

    if cfg.family == "ssm" and shape.kind != "decode" \
            and shape.seq_len > SEQ_PROBES[-1]:
        (f1, parts1), (f2, parts2) = (depth(s) for s in SEQ_PROBES)
        l1, l2 = SEQ_PROBES
        full = _extrap(f1, f2, (shape.seq_len - l1) / (l2 - l1))
        full["probes"] = {"seq": list(SEQ_PROBES),
                          "periods": [parts1, parts2]}
    else:
        full, parts = depth(shape.seq_len)
        full["probes"] = {"periods": list(parts)}
    return full


def roofline(cost: Dict[str, float], coll: Dict[str, int],
             cfg: ArchConfig, shape: ShapeConfig, n_chips: int
             ) -> Dict[str, Any]:
    """Three-term roofline per device, on H100 constants."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(coll.get("hbm_bytes", 0.0))
    coll_dev = float(coll.get("collective_bytes", 0))
    terms = {"compute": flops_dev / PEAK_FLOPS,
             "memory": bytes_dev / HBM_BW,
             "collective": coll_dev / LINK_BW}
    bottleneck = max(terms, key=terms.get)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_active = model_mod.count_params(cfg, active_only=True)
    passes = 6 if shape.kind == "train" else 2
    model_flops = passes * n_active * tokens
    total = flops_dev * n_chips
    return {
        "per_device": {"flops": flops_dev, "hbm_bytes": bytes_dev,
                       "collective_bytes": coll_dev},
        "terms_s": terms,
        "bottleneck": bottleneck,
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / total) if total else 0,
        "roofline_fraction": (model_flops / n_chips / PEAK_FLOPS)
        / max(max(terms.values()), 1e-12),
        "step_time_bound_s": max(terms.values()),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_path: Optional[str] = None) -> Dict[str, Any]:
    shape = SHAPES[shape_name]
    ok, reason = cell_applicable(get_config(arch), shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "applicable": ok,
                           "device": "H100 SXM (modelled; traced on the "
                           "meta device)"}
    if not ok:
        rec["skip_reason"] = reason
        return _emit(rec, out_path)
    n_chips = mesh.size
    cfg = dryrun_config(arch)
    dpx = sh.dp_axes(mesh)
    dp = math.prod(mesh.shape[a] for a in dpx)
    b = shape.global_batch
    b_dev = b // dp if b % dp == 0 else b
    accum = GRAD_ACCUM.get(arch, 1) if shape.name == "train_4k" else 1
    if b_dev % accum:
        accum = 1

    # --- memory: the per-device batch, arguments exact from the specs ---
    t0 = time.time()
    fn, args, specs = build_cell(cfg, shape, mesh)
    arg_dev = sum(per_device_bytes(a, s, mesh) for a, s in zip(args, specs))
    m_dev = measure(cfg, shape, b_dev, accum)
    temp = m_dev["peak_bytes"] - m_dev["argument_bytes"]
    if shape.kind == "train":
        params = args[0]["params"]
        gsize = 4 if accum > 1 else None
        full = sum(t.numel() * (gsize or t.element_size())
                   for _, t in sh.leaves_with_keys(params))
        dev = sum(t.numel() * (gsize or t.element_size())
                  // _shards(s, mesh) for (_, t), s in zip(
                      sh.leaves_with_keys(params),
                      sh.spec_leaves(specs[0]["params"])))
        temp = temp - full + dev
    peak = arg_dev + temp
    rec["grad_accum"] = accum
    rec["memory"] = {"argument_bytes": int(arg_dev),
                     "temp_bytes": int(temp),
                     "peak_per_device_gb": round(peak / 2 ** 30, 3)}
    rec["fits_hbm_80gb"] = rec["memory"]["peak_per_device_gb"] < HBM_GB
    rec["memory_trace_s"] = round(time.time() - t0, 1)
    if multi_pod:
        # the multi-pod pass proves the "pod" axis shards (memory); the
        # roofline table is single-pod only, as in the JAX package
        return _emit(rec, out_path)

    # --- analysis: the global batch, split over the mesh ---
    t0 = time.time()
    m = measure(cfg, shape, b)
    params = args[0]["params"] if shape.kind == "train" else args[0]
    pspecs = specs[0]["params"] if shape.kind == "train" else specs[0]
    coll = collectives(cfg, shape, mesh, pspecs, params)
    coll["collective_bytes"] = sum(coll[k] for k in hloanalysis.COLLECTIVES)
    coll["hbm_bytes"] = m["hbm_bytes"] / n_chips
    rec["analysis"] = {"probes": m.pop("probes"), "n_periods":
                       cfg.n_periods(), "period_len": len(cfg.period())}
    rec["kernels"] = m["kernels"]
    rec["collectives"] = coll
    rec["cost"] = {"flops": m["flops"] / n_chips,
                   "kernel_flops": m["kernel_flops"] / n_chips}
    rec["trace_s"] = round(time.time() - t0, 1)
    rec["roofline"] = roofline(rec["cost"], coll, cfg, shape, n_chips)
    return _emit(rec, out_path)


def _emit(rec, out_path):
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape x mesh) cell in "
                         "subprocesses")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--out-dir", default=os.path.abspath(RESULTS_DIR))
    args = ap.parse_args()

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape are required without --all")
        out = os.path.join(
            args.out_dir, f"{args.arch}__{args.shape}__"
            f"{'2x16x16' if args.multi_pod else '16x16'}.json")
        rec = run_cell(args.arch, args.shape, args.multi_pod, out)
        print(json.dumps(rec, indent=1))
        return

    cells = [(arch, shape_name, mp) for mp in (False, True)
             for arch in ARCH_IDS for shape_name in SHAPES]
    procs: Dict[Any, Any] = {}
    failures = []
    while cells or procs:
        while cells and len(procs) < args.jobs:
            arch, shape_name, mp = cells.pop(0)
            out = os.path.join(
                args.out_dir, f"{arch}__{shape_name}__"
                f"{'2x16x16' if mp else '16x16'}.json")
            if os.path.exists(out):
                print(f"skip (cached): {out}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name,
                   "--out-dir", args.out_dir]
            if mp:
                cmd.append("--multi-pod")
            procs[subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE)] = (arch, shape_name, mp)
        for p in [p for p in procs if p.poll() is not None]:
            cell = procs.pop(p)
            if p.returncode != 0:
                err = p.stderr.read().decode()[-2000:]
                failures.append((cell, err))
                print(f"FAIL {cell}:\n{err}")
            else:
                print(f"ok   {cell}")
        time.sleep(2)
    print(f"\n{len(failures)} failures")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
