"""Serving launcher (PyTorch port of ``repro.launch.serve``): open-loop
continuous batching vs the fixed-batch baseline on a reduced config.

Requests arrive on their own (virtual) clock (Poisson, diurnal or
bursty) and enter a ``ContinuousServeLoop`` slot as soon as one frees;
``--engine fixed`` replays the same stream through the drain-to-slowest
batch loop, and ``--engine both`` reports the head-to-head.  Latency
percentiles are in virtual seconds (one decode step = ``--step-ms``);
``wall_s`` is real time.  The port serves the dense, MoE, hybrid and
xLSTM families (llama3.2-1b, granite-moe-1b-a400m, zamba2-2.7b,
xlstm-1.3b, ...); the audio and VLM families raise
``NotImplementedError``.  Hybrid and xLSTM configs prefill at the exact
prompt length.

Example:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --engine both --arrival-regime burst --offered-load 0.6 \\
        --requests 24 --target-p99-ms 400 --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --engine both --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \\
        --engine both --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import ARCH_IDS, reduced_config
from repro_torch.core import telemetry
from repro_torch.models import transformer as tf
from repro_torch.runtime.admission import (ARRIVAL_REGIMES, request_stream,
                                           run_fixed_batch, run_open_loop)
from repro_torch.runtime.serve_loop import ContinuousServeLoop, ServeLoop


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--engine", default="continuous",
                    choices=["continuous", "fixed", "both"])
    ap.add_argument("--arrival-regime", default="poisson",
                    choices=list(ARRIVAL_REGIMES),
                    help="open-loop arrival process for the request "
                         "stream (virtual time)")
    ap.add_argument("--offered-load", type=float, default=0.5,
                    help="mean arrival rate in requests per virtual "
                         "second")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4,
                    help="continuous engine slot capacity")
    ap.add_argument("--batch", type=int, default=0,
                    help="fixed-batch size (default: --slots)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--step-ms", type=float, default=50.0,
                    help="virtual cost of one decode step")
    ap.add_argument("--target-p99-ms", type=float, default=500.0,
                    help="SLO: p99 per-token latency ceiling")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    ap.add_argument("--emit-trace", metavar="PATH", default=None,
                    help="record telemetry and write a Chrome trace-"
                         "event JSON (Perfetto-loadable) to PATH; the "
                         "metrics summary lands at PATH + "
                         "'.summary.json'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    tel = (telemetry.enable() if args.emit_trace else telemetry.get())

    cfg = reduced_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = tf.init_params(gen, cfg, device=device)
    batch = args.batch or args.slots
    step_s = args.step_ms / 1e3

    # the fixed baseline needs equal-length prompts; the continuous
    # engine takes the stream ragged
    prompt_lens = ((max(1, args.prompt_len // 2), args.prompt_len)
                   if args.engine == "continuous"
                   else (args.prompt_len, args.prompt_len))

    def stream():
        return request_stream(
            args.requests, args.offered_load, args.seed,
            regime=args.arrival_regime, vocab=cfg.vocab,
            prompt_lens=prompt_lens,
            max_new=(max(1, args.new_tokens // 2), args.new_tokens))

    out = {"arch": args.arch, "engine": args.engine,
           "device": str(device),
           "arrival_regime": args.arrival_regime,
           "offered_load": args.offered_load,
           "requests": args.requests, "slots": args.slots,
           "batch": batch, "step_ms": args.step_ms,
           "target_p99_ms": args.target_p99_ms}

    def emit(name, report, wall):
        p99_ms = report.token_lat_p99 * 1e3
        out[name] = {
            "finished": report.finished,
            "decoded_tokens": report.decoded_tokens,
            "prefill_tokens": report.prefill_tokens,
            "virtual_s": round(report.elapsed_s, 3),
            "tokens_per_virtual_s": round(report.tokens_per_s, 2),
            "token_lat_p50_ms": round(report.token_lat_p50 * 1e3, 2),
            "token_lat_p99_ms": round(p99_ms, 2),
            "ttft_p99_ms": round(report.ttft_p99 * 1e3, 2),
            "queue_wait_p99_ms": round(report.queue_wait_p99 * 1e3, 2),
            "slo_met": bool(p99_ms <= args.target_p99_ms),
            "wall_s": round(wall, 2)}

    if args.engine in ("continuous", "both"):
        loop = ContinuousServeLoop(cfg, params, slots=args.slots,
                                   max_len=args.max_len)
        t0 = time.time()
        rep = run_open_loop(loop, stream(), step_s=step_s)
        _sync(device)
        emit("continuous", rep, time.time() - t0)
    if args.engine in ("fixed", "both"):
        loop = ServeLoop(cfg, params, max_len=args.max_len)
        t0 = time.time()
        rep = run_fixed_batch(loop, stream(), batch, step_s=step_s)
        _sync(device)
        emit("fixed", rep, time.time() - t0)
    if args.engine == "both":
        c, f = out["continuous"], out["fixed"]
        out["continuous_speedup"] = round(
            c["tokens_per_virtual_s"]
            / max(f["tokens_per_virtual_s"], 1e-9), 3)
    if args.emit_trace:
        tel.write_chrome_trace(args.emit_trace)
        tel.write_summary(args.emit_trace + ".summary.json")
        out["emit_trace"] = args.emit_trace
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
