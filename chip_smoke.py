#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; without a CUDA device it exits
non-zero before printing any result):

1. Environment: the card's name and power limit (``nvidia-smi``), torch,
   CUDA, triton and nvcc versions.  TF32 is switched off.
2. Build the hand-written kernels from ``src/repro_torch/kernels/*/csrc``
   with nvcc (``build`` lines: time, ptxas registers and spills).
3. Hold the kernel against its plain PyTorch version on the card at
   llama3.2-1b's prefill shapes (H=32, KV=8, hd=64; B=1 at S 128, 256,
   512, 1024 and a ragged 1000, and B=4 at S=512 as the fixed-batch
   serve runs it; a 256-token window; hd=80 through the padding wrapper;
   non-causal; bf16 and f32), at phi3.5-moe's and the vision model's
   hd=128 (B=1, S=1024) and at group 1, whisper-small's 12 heads over 12
   KV heads (B=1 at S=1024, B=4 at S=512), and time the kernel, the plain
   version and ``torch.nn.functional.scaled_dot_product_attention`` (the
   library yardstick, which the port itself never calls).
4. Serve full-width llama3.2-1b in bf16 (random weights from a seed):
   ``ContinuousServeLoop`` (8 slots, max_len 2048) under
   ``run_open_loop`` over 16 Poisson-arrival requests (prompts 256-1024
   tokens, 16-32 new tokens), then one ``ServeLoop`` batch of 4 equal
   prompts under ``run_fixed_batch``.  Every shape of the two drives is
   run once before anything else on the card, right after the build
   (``first-call`` lines: what a freshly started server pays), so that
   the drives time warm serving.  Checks that every request finished, that the kernel ran
   exactly (prefills x 16 layers) times, and that the prefill logits of
   three requests through the kernel are no further (within 1.25 times)
   from an f32 forward of the same weights than the plain path's.  Then
   profiles one 1024-token prefill and 8-lane decode steps
   (device time by kernel, the device's idle share).
5. Training (slice 2).  Checks one full-width micro-batch (2 x 1024
   tokens): loss and flat gradient through the kernel path and the plain
   path against an f32 witness (``train-check``); sends one step's four
   per-rank gradients through every sync schedule (``sync-check``:
   compressed at frac 1.0 bit-identical to hierarchical, flat and ring
   within 1e-6); then trains full-width llama3.2-1b with
   ``FaabricTrainRuntime``: 4 virtual ranks in 2 pods, compressed sync at
   frac 0.05, global batch 8 x 1024, 12 steps (``train``: every loss,
   step time p50/p99, tokens/s, peak memory, launches per kernel), times
   one more step's parts (``train-anatomy``) and profiles another.
   Then the analysis path (slice 15, ``dryrun`` lines) at the JAX
   package's assigned shapes (slice 17): each of ``DRYRUN_CELLS``
   (train_4k for llama3.2-1b, llama3.2-3b, granite-moe-1b-a400m and,
   since slice 18, xlstm-1.3b, micro-batched by ``GRAD_ACCUM``;
   prefill_32k for llama3.2-1b, glm4-9b, zamba2-2.7b and xlstm-1.3b;
   decode_32k for llama3.2-1b and minitron-4b over a full seeded cache at
   position 32767 and for xlstm-1.3b (100 sequences of mLSTM state);
   long_500k for zamba2-2.7b, its ring of 4096 wrapped 127 times, and
   xlstm-1.3b at position 524287;
   full width and depth, each global batch cut as the line's ``reduced``
   says; and the flash kernels' forward and backward at 2 x 1024) is
   analysed by ``launch.dryrun.trace`` on the meta device and on fake
   CUDA tensors (which must agree), every kernel counted by its
   ``work()``, then run on the card (one warm step, three timed with
   CUDA events, one where the warm step took 2 s or more; five for
   flash): the kernel calls equal the counters, the
   predicted peak memory is within 10% of ``max_memory_allocated()``, no
   step is faster than its bound (H100 constants), and its logits or loss
   are finite.  Each line prints the counted and model FLOPs, HBM bytes,
   the terms, the bound, the p50, ``mfu`` and ``roofline_fraction``.  A
   planted analysis that ignores remat must fail the launch gate (on
   train_4k-llama1b), one that keeps no lse or f32 output for flash's
   backward the memory gate.  Then a 500k-token context (slice 17,
   ``long-serve``): zamba2-2.7b whole through ``ServeLoop`` with the
   long_500k window of 4096, a seeded prompt of 524,224 tokens (not a
   multiple of the window) and 64 greedy tokens up to position 524,287,
   held against the model's windowed forward over the same 524,288
   tokens (the prefill's logits within the serving tolerance; the
   decode's, which bf16 carries 0.28-0.46 apart at full depth, nearer
   than unrelated logits), after an f32 control of the same path at
   12,288 tokens whose every served token is the forward's; before it,
   mamba_scan at 524,288 tokens with slow gates and flash at S 524,288
   with the window, each against its plain version and a planted copy
   that must fail.
6. The data plane (slice 3) over the full-width llama3.2-1b train state
   (params bf16, AdamW moments f32: 12.36 GB).  ``diffsync-check``: fork
   a copy of a state, take one gang step from it to get the child, and
   merge child into fork with ``core.diffsync.fused_diff_apply`` leaf by
   leaf (op ``sum``, then ``overwrite``): every leaf of 2^20 elements or
   more goes through the diff_merge kernel, bit for bit equal to its
   plain version; the norms and the step take the host path; the
   overwrite merge has the child's fingerprint.  ``ckpt`` (1 of the 16
   layers at full width, a 3.24 GB state, for the script's time limit):
   the gang runtime (4 ranks, 2 pods, compressed sync at frac 1.0, 4
   steps) run
   once uninterrupted (saving only the state before step 0) and once
   with checkpoints every 2 steps and a failure at step 3 (recovery to
   the step-2 checkpoint), losses equal within 1e-6 and the final
   states bit for bit (on the card);
   then a delta-chain manager over 2 saves restored bit for bit, and a
   delta migration checked with ``verify_migration``.
7. The shared Fabric (slice 9): ``Fabric.run_trace`` over 8 virtual
   devices (2 a host) runs two train gangs of full-width llama3.2-1b
   (4 chips with compressed sync over 2 pods, 2 chips hierarchical; 3
   steps each) and two serve gangs (2 requests of 3 tokens each) through
   a high-priority arrival that preempts a train gang (it resumes), a
   hard host failure that rolls a train gang back to its last snapshot,
   a lease reclaim that evacuates one (a live migration), and delta
   checkpoints every 10 virtual seconds.  Prints ``fabric-*`` lines
   (live and predicted makespans and orders, ``diff_traces``, the stall
   of each preempt, checkpoint, failure and resume, each move's seconds
   and bytes, placement decision latencies, peak device memory, the
   device's idle share, the trace's kernel launches) and checks the live
   completion order against ``predict_trace``, every resumed state's
   fingerprint against its snapshot's, and the rolled-back gang's losses
   against an uninterrupted run of it (atol 1e-6); 2 of the 16 layers.
   Then, on a fresh
   pool of 8, the grow-with-drain step (slice 10): a 6-chip train gang
   and a 2-chip serve gang of full-width llama3.2-1b; a
   ``ServeAutoscaler`` under a breach emits "need" 4, and
   ``Fabric.grow_with_drain`` grows the serve gang to 4 by draining the
   train gang to 3; the donor's state must be bit for bit unchanged by
   the drain, both gangs step again, and a grow to 8 must raise
   (``fabric-grow-drain``).  Then the risk-aware spot wave (slice 16,
   ``fabric-spot``): examples/spot_fleet_torch.py's act 2
   (``risk_aware_wave``) with gangs of the same width and depth, on 6
   virtual chips (3 hosts of 2) with a spare host of 2
   and ``CostModel(risk_tau_s=4.0)``: a 4-chip train gang and a 2-chip
   serve gang, host 0 hard-failing at 6 s and the spare host joining at
   10 s, ``shrink_recovery`` on, checkpoints every 4 s; the live Action
   log must equal ``predict_trace``'s, the train gang must shrink onto
   its survivors and regrow with no recovery and no lost work, and each
   reshard must equal the replica it came from bit for bit.  Then the
   examples (slice 16, ``examples``): each of the four twins of the JAX
   package's examples (``examples/*_torch.py``) runs on the card, with
   its own assertions, its control-plane outcomes held against those
   the JAX example prints and its kernel launches counted.
8. Serves the MoE, hybrid, xLSTM, audio and VLM families at full width
   (granite-moe-1b-a400m, phi3.5-moe-42b-a6.6b cut to 8 of its 32
   layers, zamba2-2.7b, xlstm-1.3b cut to 8 of its 48, whisper-small,
   llama-3.2-vision-11b; the others at full depth; bf16, random weights
   from a seed, the vision model's cross-attention gates drawn from
   N(0, 1); the audio and VLM requests carry the serve CLI's seeded
   frames and image tokens): first use of every serve shape, 8 Poisson
   requests through ``ContinuousServeLoop`` and a ``ServeLoop`` batch of
   4 x 512 (``serve-moe``, ``serve-moe_phi``, ``serve-hybrid``,
   ``serve-ssm``, ``serve-audio``, ``serve-vlm``: every kernel count
   against the path's formula), the prefill check against an f32
   witness (for the MoE configs each MoE layer also held alone), and a
   profile of each.
9. Trains the audio, VLM and MoE families (slice 11) with
   ``FaabricTrainRuntime`` at full width (``train-family-*``):
   whisper-small whole (4 ranks, 8 x 448 tokens with (8, 1500, 768)
   frames), granite-moe-1b-a400m whole (2 ranks, 8 x 1024) and
   llama-3.2-vision-11b cut to 10 of its 40 layers (2 ranks, 2 x 1024 with
   image tokens, gates drawn).  Before each run, step 0's loss and every
   gradient leaf through the kernels are held against the plain paths
   and an f32 witness (``train-family-grad``, the MoE routes pinned);
   after it the loss must have fallen and every kernel count equal the
   path's formula (flash and moe_gmm forwards twice a step under remat,
   their backwards once, every moe_gmm backward through the wgmma
   design); then one more warm granite step is profiled
   (``profile train_step_moe``).  Then the hybrid and xLSTM families
   (slice 13): zamba2-2.7b cut to 12 of its 54 layers (2 ranks, 4 x
   1024; whole until slice 17) and xlstm-1.3b cut
   to 16 of its 48 layers (2 ranks, 4 x 512), every mamba_scan and mlstm
   backward through the tensor-core route, "mma.sync" (slice 14), and
   xlstm's sLSTM through the slstm scan kernels (slice 18).  Each
   family's kernel counts must also equal the analysis's calls of one
   rank's step (``predicted_step_calls``, slice 15) times ranks x steps.
10. Prints the ``kernels`` JSON line and, last, the device JSON line.

Besides the forward kernel, phase 2 builds the flash-attention backward
kernel and the collective_codec, diff_merge, moe_gmm (forward and
backward), mamba_scan, mlstm and slstm (forward and backward) kernels
(one nvcc each, all started together), and phase 3 holds each against
its plain version: the
backward's dq, dk, dv against autograd of the plain attention
(``kernel-check bwd``; also at the train families' rank batches:
whisper-small's group 1, granite's group 2 and llama-3.2-vision-11b's hd
128), the codec bit for bit up to the main
path's launch over four full-width shards (``kernel-check codec``),
diff_merge bit for bit over every merge op and dtype at the JAX tests'
shapes, then timed at the embedding's size (``kernel-check
diff_merge``), moe_gmm at granite's (its training M 1280 too) and
phi3.5-moe's shapes (its bf16
route is two launches: gate-up, then down), each with one more case
whose h has a large common part (one bf16 rounding of h fails it) and,
beside each bf16 row, the time of the cuBLAS composition of the same FFN
(three ``torch.bmm`` and the elementwise ops, h rounded to bf16: another
function, not one call), moe_gmm's backward (``kernel-check
moe_gmm_bwd``: dx, dw1, dw2, dw3 against autograd of the plain version
at granite's training shape and phi3.5-moe's prefill shape, both acts,
bf16 and f32, bit-equal on a rerun, and a common-part case that a
planted copy rounding h once in dw2 must fail, all through the wgmma
design, and two shapes TMA cannot describe through the mma.sync design,
each row naming its design; beside each bf16 row each launch's time and
the time of autograd of the cuBLAS composition), mamba_scan at zamba2's
(``kernel-check mamba_scan``: with the model's gates and with slow ones
that carry the state over several chunks, and one case whose state has a
large common part) and mlstm at xlstm-1.3b's (``kernel-check mlstm``: a
1024-token prefill, a ragged 1000, the 4 x 512 batch and an initial
state, with the model's forget gates and with slow ones that carry C
over several chunks, one case whose C has a large common part, and the
JAX tests' small shapes, prefill_32k's 32768 tokens, and a precision
row at the training shape: h and the final C against float64 no
further than the plain version's, within ``ref.precision``'s factors,
which the copy with two-part f32 operands must fail), the slstm scan
(slice 18, redesigned in slice 19; ``kernel-check slstm`` / ``slstm_bwd``:
at xlstm-1.3b's width on training's 2 x 512, train_4k's 1 x 4096,
prefill_32k's 1 x 32768, a decode step of 100 rows from a state and a
ragged 1000 from a state, with slow forget gates and r of another scale
per head, against the token loop and, up to 4096 steps, an f64 witness;
planted copies with the recurrent term gate-major, without the
stabiliser's rescale and with a consumer that takes a ring word whatever
its tag must fail, and the backward's without the carry's factor fi;
each row's time per step beside its bound, the tagged exchange's own
cost and the grid barrier's; the backward at 2 x 512, 1 x 4096 and a
ragged row from a state with the final state's gradients, against
autograd of the loop), and the mamba_scan and mlstm backwards at the
training shapes (``kernel-check mamba_scan_bwd`` / ``mlstm_bwd``: against
autograd of the plain versions and an f32 witness, slow gates, both sides
of mlstm's floor and a common-part row each; planted copies with the
carry dropped, the floor ignored or a state rounded once must fail; each
row names the route that ran and the kernels' ptxas registers).

Checkpoints go to ``build/chip_smoke_ckpt`` in the checkout and are
removed at the end; the phase raises if the disk cannot hold three full
checkpoints of the state.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense bf16 tensor cores
              "float32": 67e12}    # f32 on the CUDA cores (TF32 off)
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
MAX_LEN = 2048                     # the serve loops' decode buffer
CKPT_ROOT = os.path.join(REPO, "build", "chip_smoke_ckpt")


def _sh(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e.__class__.__name__})"


def _host_rss_gb():
    """The process's resident host memory, GB (Linux), or NaN."""
    try:
        with open("/proc/self/status") as f:
            kb = next(int(ln.split()[1]) for ln in f
                      if ln.startswith("VmRSS:"))
        return kb / 1e6
    except (OSError, StopIteration, ValueError):
        return float("nan")


def _time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _roof(flops, nbytes, dtype_name):
    """(least time in ms, what bounds it): the larger of the bytes over
    HBM bandwidth and the operations over the dtype's peak."""
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _bound(b, h, kv, s, hd, causal, window, dtype_name, esize):
    """Least time for the attention function on this input, from the
    kernel's ``work`` (flash_attention/ops.py)."""
    from repro_torch.kernels.flash_attention import ops
    flops, nbytes = ops.work(b, h, kv, s, hd, causal, window, esize)
    return (*_roof(flops, nbytes, dtype_name), flops)


def check_kernel(torch, fa_ops, fa_ref, F):
    """Phase 3: kernel vs plain version at the serve path's shapes: 32
    query heads over 8 KV heads (llama3.2-1b, phi3.5-moe, the vision
    model), and group 1 at whisper-small's 12 over 12; and at the train
    families' rank batches (whisper-small's 2 x 448, granite-moe's group
    2 at 4 x 1024)."""
    cases = [  # (B, S, hd, causal, window, dtype[, H, KV]); H 32, KV 8
        (1, 128, 64, True, 0, "bfloat16"), (1, 128, 64, True, 0, "float32"),
        (1, 256, 64, True, 0, "bfloat16"), (1, 512, 64, True, 0, "bfloat16"),
        (1, 1024, 64, True, 0, "bfloat16"), (1, 1024, 64, True, 0, "float32"),
        (1, 1000, 64, True, 0, "bfloat16"), (1, 1000, 64, True, 0, "float32"),
        (1, 1024, 64, True, 256, "bfloat16"),
        (1, 1024, 64, True, 256, "float32"),
        (1, 1024, 80, True, 0, "bfloat16"), (1, 1024, 80, True, 0, "float32"),
        (1, 1000, 64, False, 0, "float32"),
        # the fixed-batch serve's prefill: 4 prompts of 512 tokens
        (4, 512, 64, True, 0, "bfloat16"), (4, 512, 64, True, 0, "float32"),
        # the training micro-batch: 2 sequences of 1024 tokens
        (2, 1024, 64, True, 0, "bfloat16"), (2, 1024, 64, True, 0, "float32"),
        # phi3.5-moe's native head dim (its prefill of 1024 tokens)
        (1, 1024, 128, True, 0, "bfloat16"),
        (1, 1024, 128, True, 0, "float32"),
        # group 1: whisper-small's decoder (12 heads over 12 KV heads)
        (1, 1024, 64, True, 0, "bfloat16", 12, 12),
        (1, 1024, 64, True, 0, "float32", 12, 12),
        (4, 512, 64, True, 0, "bfloat16", 12, 12),
        (4, 512, 64, True, 0, "float32", 12, 12),
        # the train families' rank batches: whisper-small's 2 x 448, and
        # granite-moe-1b-a400m's 4 x 1024 at group 2 (16 heads over 8)
        (2, 448, 64, True, 0, "bfloat16", 12, 12),
        (4, 1024, 64, True, 0, "bfloat16", 16, 8),
        (4, 1024, 64, True, 0, "float32", 16, 8),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for case in cases:
        b, s, hd, causal, window, dname = case[:6]
        h, kv = case[6:] or (32, 8)
        dt = getattr(torch, dname)
        q = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((b, s, kv, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((b, s, kv, hd), generator=gen, device="cuda").to(dt)
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ref = fa_ref.attention_ref(qt, kt, vt, causal=causal,
                                   window=window).transpose(1, 2)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(out.float()).all()) and torch.allclose(
            out.float(), ref.float(), atol=TOL[dname], rtol=TOL[dname])
        row = {"B": b, "S": s, "H": h, "KV": kv, "hd": hd,
               "causal": causal, "window": window, "dtype": dname,
               "max_abs_err": err, "tol": TOL[dname], "ok": ok}
        if hd in (64, 128):
            # times on the kernel's own (B,H,S,hd) layout
            ms = _time_ms(lambda: fa_ops._launch(
                qt, kt, vt, causal=causal, window=window, scale=hd ** -0.5))
            plain_ms = _time_ms(lambda: fa_ref.attention_ref(
                qt, kt, vt, causal=causal, window=window), iters=5)
            mask = None
            if window:
                i = torch.arange(s, device="cuda")
                mask = (i[:, None] >= i[None, :]) & \
                    (i[:, None] - i[None, :] < window)
            try:
                lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=True))
            except RuntimeError as e:      # the yardstick only, not the port
                print(f"library call unavailable: {e}", flush=True)
                lib_ms = None
            bound_ms, bound_by, flops = _bound(b, h, kv, s, hd, causal,
                                               window, dname,
                                               q.element_size())
            row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       tflops=flops / (ms * 1e-3) / 1e12)
        rows.append(row)
        print(f"kernel-check {json.dumps(row)}", flush=True)
    fa_ops.reset_launches()
    return rows


# The first calls that run under the profiler for a family whose prefill
# is a loop over tokens (see warm_up).
def warm_up(torch, cfg, params, max_len, extras=None):
    """Run every shape of the timed drives once before them, so that the
    serve numbers measure serving and not first use: the B=1 ragged
    prefill at the 256, 512 and 1024 buckets and an 8-lane decode step,
    then the 4 x 512 fixed-batch prefill and a 4-lane decode step.  Each
    first call runs under ``torch.profiler`` (its own start-up is paid
    on an empty region before) and is then repeated without it; a
    ``first-call`` line gives both wall times, the first call's device
    time, and its host operations by self time, which is where a
    one-time cost shows.  ``extras``: the (per-request, per-batch) extras functions of an audio
    or VLM config (``launch.serve._extras_fns``)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch.runtime.serve_loop import (ContinuousServeLoop, Request,
                                                ServeLoop)

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tprofile(activities=acts):
        torch.ones(1, device=params["embed"].device).add_(1)
    torch.cuda.synchronize()
    rng = np.random.default_rng(3)

    def req(n, new=4):
        return Request(rid=0, prompt=rng.integers(0, cfg.vocab, n,
                                                  dtype=np.int32),
                       max_new_tokens=new)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def first_and_warm(name, fn):
        with tprofile(activities=acts) as prof:
            first = timed(fn)
        device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == DeviceType.CUDA)
        host = sorted((e for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU),
                      key=lambda e: e.self_cpu_time_total, reverse=True)
        warm = timed(fn)
        row = {"call": name, "first_ms": first * 1e3, "warm_ms": warm * 1e3,
               "first_device_ms": device_us * 1e-3,
               "first_host_self_ms": [
                   {"op": e.key[:60], "ms": e.self_cpu_time_total * 1e-3,
                    "calls": e.count} for e in host[:6]]}
        print(f"first-call {json.dumps(row)}", flush=True)

    # the extras (drawn on the host) are made before the timed calls
    one, batch = extras or (None, None)
    ex = one(req(1)) if one else None
    fex = batch([req(1)] * 4) if batch else None
    loop = ContinuousServeLoop(cfg, params, slots=8, max_len=max_len)
    for n in (256, 512, 1024):
        first_and_warm(f"prefill_1x{n}",
                       lambda: loop.admit(req(n), extras=ex))
    first_and_warm("decode_step_8_lanes", loop.decode_step)
    del loop
    fixed = ServeLoop(cfg, params, max_len=max_len)
    first_and_warm("fixed_prefill_4x512", lambda: fixed.start(
        [req(512) for _ in range(4)], extras=fex))
    first_and_warm("fixed_decode_step_4_lanes", fixed.decode_step)
    del fixed


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(math.ceil(q / 100 * len(xs))) - 1)]


def _drive_continuous(torch, cfg, params, reqs, extras_fn=None):
    """``ContinuousServeLoop`` (8 slots) under ``run_open_loop`` over
    ``reqs`` (with each request's ``extras_fn(req)``), each admission and
    decode step timed to the device's end.  Returns the
    ``serve-continuous`` numbers and the number of prefills."""
    from repro_torch.runtime.admission import run_open_loop
    from repro_torch.runtime.serve_loop import ContinuousServeLoop

    loop = ContinuousServeLoop(cfg, params, slots=8, max_len=MAX_LEN)
    prefill_s, step_s = [], []
    orig_admit, orig_step = loop.admit, loop.decode_step

    def admit(req, now=None, extras=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slot = orig_admit(req, now=now, extras=extras)
        torch.cuda.synchronize()
        if slot is not None:
            prefill_s.append(time.perf_counter() - t0)
        return slot

    def decode_step(now=None):
        t0 = time.perf_counter()
        lanes = orig_step(now=now)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return lanes

    loop.admit, loop.decode_step = admit, decode_step
    t0 = time.perf_counter()
    rep = run_open_loop(loop, reqs, extras_fn=extras_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert rep.finished == len(reqs), (rep.finished, len(reqs))
    assert all(len(r.out) == r.max_new_tokens for r in reqs)
    cont = {"requests": len(reqs), "prefills": loop.stats.admitted,
            "prefill_tokens": rep.prefill_tokens,
            "decoded_tokens": rep.decoded_tokens, "steps": rep.steps,
            "wall_s": wall, "tokens_per_s": rep.decoded_tokens / wall,
            "ttft_ms_p50": _pct(prefill_s, 50) * 1e3,
            "ttft_ms_p99": _pct(prefill_s, 99) * 1e3,
            "token_ms_p50": _pct(step_s, 50) * 1e3,
            "token_ms_p99": _pct(step_s, 99) * 1e3}
    return cont, loop.stats.admitted


def _drive_fixed(torch, cfg, params, freqs, extras_fn=None):
    """One ``ServeLoop`` batch of ``freqs`` under ``run_fixed_batch``
    (with the batch's ``extras_fn(reqs)``), timed like the continuous
    drive; returns the ``serve-fixed`` numbers."""
    from repro_torch.runtime.admission import run_fixed_batch
    from repro_torch.runtime.serve_loop import ServeLoop

    fixed_loop = ServeLoop(cfg, params, max_len=MAX_LEN)
    fstart_s, fstep_s = [], []
    orig_start, orig_fstep = fixed_loop.start, fixed_loop.decode_step

    def start(requests, extras=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig_start(requests, extras=extras)
        torch.cuda.synchronize()
        fstart_s.append(time.perf_counter() - t0)

    def fdecode_step():
        t0 = time.perf_counter()
        more = orig_fstep()
        torch.cuda.synchronize()
        fstep_s.append(time.perf_counter() - t0)
        return more

    fixed_loop.start, fixed_loop.decode_step = start, fdecode_step
    t0 = time.perf_counter()
    frep = run_fixed_batch(fixed_loop, freqs, batch=len(freqs),
                           extras_fn=extras_fn)
    torch.cuda.synchronize()
    fwall = time.perf_counter() - t0
    assert frep.finished == len(freqs)
    assert all(len(r.out) == r.max_new_tokens for r in freqs)
    return {"requests": len(freqs), "prefills": 1,
            "decoded_tokens": frep.decoded_tokens, "steps": frep.steps,
            "wall_s": fwall, "tokens_per_s": frep.decoded_tokens / fwall,
            "prefill_ms": fstart_s[0] * 1e3,
            "token_ms_p50": _pct(fstep_s, 50) * 1e3,
            "token_ms_p99": _pct(fstep_s, 99) * 1e3}


def serve(torch, cfg, params, n_layers):
    """Phase 4: the port's main serving path at full width."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.runtime.admission import request_stream

    reqs = request_stream(16, 0.25, seed=0, regime="poisson",
                          vocab=cfg.vocab, prompt_lens=(256, 1024),
                          max_new=(16, 32))
    fa_ops.reset_launches()
    cont, admitted = _drive_continuous(torch, cfg, params, reqs)
    launches_cont = fa_ops.launches
    assert launches_cont == admitted * n_layers, \
        (launches_cont, admitted, n_layers)
    cont["flash_launches"] = launches_cont
    print(f"serve-continuous {json.dumps(cont)}", flush=True)

    freqs = request_stream(4, 0.25, seed=1, regime="poisson",
                           vocab=cfg.vocab, prompt_lens=(512, 512),
                           max_new=(16, 32))
    fa_ops.reset_launches()
    fixed = _drive_fixed(torch, cfg, params, freqs)
    launches_fixed = fa_ops.launches
    assert launches_fixed == 1 * n_layers, launches_fixed
    fixed["flash_launches"] = launches_fixed
    print(f"serve-fixed {json.dumps(fixed)}", flush=True)
    return reqs, launches_cont + launches_fixed


def _plain_paths():
    """Every kernel of the serve and train paths swapped for its plain
    version (the wrappers' shape handling stays; their launch runs the
    plain version, and moe_gmm's autograd route autograd of it)."""
    from contextlib import ExitStack

    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mamba_scan import ref as scan_ref
    from repro_torch.kernels.mlstm import ops as ml_ops
    from repro_torch.kernels.mlstm import ref as ml_ref
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.moe_gmm import ref as gmm_ref
    from repro_torch.kernels.slstm import ops as sl_ops
    from repro_torch.kernels.slstm import ref as sl_ref
    from repro_torch.models import attention as attn

    stack = ExitStack()
    stack.enter_context(mock.patch.object(attn, "causal_attention",
                                          attn.plain_causal_attention))
    stack.enter_context(mock.patch.object(
        gmm_ops, "_launch", lambda x, w1, w2, w3, act:
        gmm_ref.expert_ffn_ref(x, w1, w2, w3, act=act)))
    stack.enter_context(mock.patch.object(
        gmm_ops, "expert_ffn_kernel_layout", gmm_ref.expert_ffn_ref))
    stack.enter_context(mock.patch.object(
        scan_ops, "_launch", lambda x, dt, a, b, c, chunk:
        scan_ref.ssd_chunked(x, dt, a, b, c, chunk)))
    stack.enter_context(mock.patch.object(
        ml_ops, "_launch", lambda q, k, v, logi, logf, state, chunk:
        ml_ref.mlstm_chunked(q, k, v, logi, logf, state, chunk)))
    # the scans' autograd routes: autograd of the plain versions
    stack.enter_context(mock.patch.object(
        scan_ops._SSD, "apply", lambda x, dt, a, b, c, chunk:
        scan_ref.ssd_chunked(x, dt, a, b, c, chunk)))
    stack.enter_context(mock.patch.object(
        ml_ops._MLSTM, "apply", lambda q, k, v, logi, logf, chunk:
        _flat_state(ml_ref.mlstm_chunked(q, k, v, logi, logf, None,
                                         chunk))))
    stack.enter_context(mock.patch.object(
        sl_ops, "_launch", lambda gx, r, bf, state, keep:
        sl_ref.slstm_scan(gx, r, bf, state, r.shape[0]) + (None,)))
    stack.enter_context(mock.patch.object(
        sl_ops._SLSTM, "apply", lambda gx, r, bf, c0, n0, h0, m0:
        _flat_slstm(sl_ref.slstm_scan(gx, r, bf, dict(c=c0, n=n0, h=h0,
                                                      m=m0), r.shape[0]))))
    return stack


def _flat_state(out):
    """(h, (c, n, m)) as (h, c, n, m), the order ``_MLSTM.apply``
    returns."""
    return (out[0], *out[1])


def _flat_slstm(out):
    """(y, state) as (y, c, n, h, m), the order ``_SLSTM.apply``
    returns."""
    return (out[0], *(out[1][k] for k in ("c", "n", "h", "m")))


def _launch_counts():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mlstm import ops as ml_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.slstm import ops as sl_ops
    return (fa_ops.launches, gmm_ops.launches, scan_ops.launches,
            ml_ops.launches, sl_ops.launches)


def _route_recorder(routes):
    """A wrapper of ``moe._route`` that keeps each layer's (G, S, k)
    expert choice."""
    from repro_torch.models import moe as moe_mod
    orig = moe_mod._route

    def route(router_w, x, cfg):
        gates, idx, aux = orig(router_w, x, cfg)
        routes.append(idx.reshape(-1, idx.shape[-1]).sort(-1).values)
        return gates, idx, aux
    return mock.patch.object(moe_mod, "_route", route)


def _flip_share(a, b, plen):
    """Share of (token, layer) routes whose expert sets differ, over the
    prompt's real tokens."""
    diff = sum(int((x[:plen] != y[:plen]).any(-1).sum())
               for x, y in zip(a, b))
    return diff / (plen * len(a))


def check_moe_layers(torch, captured):
    """The MoE layer itself, flip-free: each layer's dispatched input of
    the bf16 kernel path through the kernel and through the plain
    version, each against the f32 FFN of the same bf16 inputs (the plain
    version before its one rounding).  Holds the bf16 tolerance and the
    1.25x criterion per layer."""
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    worst = {"kernel_vs_f32": 0.0, "plain_vs_f32": 0.0, "ratio": 0.0}
    for xe, w1, w2, w3, act in captured:
        yk = gmm_ops.expert_ffn(xe, w1, w2, w3, act=act)
        with _plain_paths():
            yp = gmm_ops.expert_ffn(xe, w1, w2, w3, act=act)
            yw = gmm_ops.expert_ffn(xe.float(), w1.float(), w2.float(),
                                    w3.float(), act=act)
        torch.cuda.synchronize()
        dk = ((yk.float() - yw).norm() / yw.norm()).item()
        dp = ((yp.float() - yw).norm() / yw.norm()).item()
        assert dk <= TOL["bfloat16"] and dk <= 1.25 * dp, (dk, dp)
        worst["kernel_vs_f32"] = max(worst["kernel_vs_f32"], dk)
        worst["plain_vs_f32"] = max(worst["plain_vs_f32"], dp)
        worst["ratio"] = max(worst["ratio"], dk / max(dp, 1e-30))
    return worst


def check_prefill(torch, cfg, params, reqs, max_len, extras_fn=None):
    """Prefill logits through the kernels and through the plain paths,
    both in bf16 on the card, each held against an f32 forward of the
    same weights on the plain paths (the witness).  Runs the serve path's
    own prefill (``make_ragged_prefill``) at the length the continuous
    loop gave each prompt (its bucket; the exact length for a recurrent
    config), over up to three prompts of distinct lengths.  Passes when,
    for every prompt, the kernel path is no further from the witness
    than 1.25 times the plain path's distance, and, for the dense family
    as since slice 1, within the bf16 tolerance of it (normwise).

    For an MoE config a routing flip (bf16 rounding moving a token's
    top-k set) separates paths that are both right, so the line gives the
    share of (token, layer) routes that differ from the witness's.  The
    whole-model criterion is held where the kernel path routes exactly as
    the plain path; the MoE layer itself is always held, on the kernel
    path's dispatched inputs (``check_moe_layers``).

    An audio or VLM config's prompts carry their extras
    (``extras_fn(req)``: encoder frames, image tokens), in bf16 for both
    bf16 paths and in f32 for the witness; the vision model's
    cross-attention gates are drawn (``draw_gates``), so that the check
    sees its cross-attention."""
    from repro_torch.configs.base import MAMBA, MLSTM, MOE, SLSTM
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.runtime.serve_loop import _bucket, make_ragged_prefill
    from repro_torch.weights import tree_map

    exact = any(k in (MAMBA, MLSTM, SLSTM) for k in cfg.period())
    moe = MOE in cfg.period()
    with_bucket = [(r, len(r.prompt) if exact
                    else min(max_len, _bucket(len(r.prompt))))
                   for r in reqs]
    picked, seen = [], set()
    for r, bucket in with_bucket:
        if bucket not in seen:
            seen.add(bucket)
            picked.append((r, bucket))
    rids = {r.rid for r, _ in picked}
    picked += [(r, b) for r, b in with_bucket if r.rid not in rids]
    picked = picked[:3]
    prefill = make_ragged_prefill(cfg)
    torch.cuda.empty_cache()
    params32 = tree_map(lambda t: t.float(), params)
    out = []
    for r, bucket in picked:
        plen = len(r.prompt)
        tokens = torch.zeros((1, bucket), dtype=torch.int32,
                             device=params["embed"].device)
        tokens[0, :plen] = torch.as_tensor(r.prompt, device=tokens.device)
        batch = {"tokens": tokens, **(extras_fn(r) if extras_fn else {})}
        batch32 = {k: (v if k == "tokens" else v.float())
                   for k, v in batch.items()}
        rk, rp, rw, captured = [], [], [], []
        orig_ffn = gmm_ops.expert_ffn

        def capture(xe, w1, w2, w3, *, act="silu"):
            captured.append((xe, w1, w2, w3, act))
            return orig_ffn(xe, w1, w2, w3, act=act)
        with _route_recorder(rk), \
                mock.patch.object(gmm_ops, "expert_ffn", capture):
            lk, _ = prefill(params, batch, plen)
        before = _launch_counts()
        with _plain_paths():
            with _route_recorder(rp):
                lp, _ = prefill(params, batch, plen)
            with _route_recorder(rw):
                lw, _ = prefill(params32, batch32, plen)
        assert _launch_counts() == before, "a plain path launched a kernel"
        torch.cuda.synchronize()
        assert lk.shape == (1, 1, cfg.vocab)
        assert bool(torch.isfinite(lk).all() & torch.isfinite(lw).all())

        def rel(a, b):
            return ((a - b).norm() / b.norm()).item()
        res = {"arch": cfg.name, "S": plen, "bucket": bucket,
               "kernel_vs_f32": rel(lk, lw), "plain_vs_f32": rel(lp, lw),
               "kernel_vs_plain": rel(lk, lp),
               "kernel_max_abs_vs_f32": (lk - lw).abs().max().item(),
               "plain_max_abs_vs_f32": (lp - lw).abs().max().item(),
               "logit_absmax": lw.abs().max().item(),
               "argmax_kernel_plain_f32": [int(x.argmax())
                                           for x in (lk, lp, lw)],
               "tol": TOL["bfloat16"]}
        whole = True
        if moe:
            res["route_flips_kernel_vs_f32"] = _flip_share(rk, rw, plen)
            res["route_flips_plain_vs_f32"] = _flip_share(rp, rw, plen)
            res["route_flips_kernel_vs_plain"] = _flip_share(rk, rp, plen)
            whole = res["route_flips_kernel_vs_plain"] == 0.0
            res["whole_model_held"] = whole
            res["moe_layers"] = check_moe_layers(torch, captured)
        del captured, batch, batch32
        print(f"prefill-check {json.dumps(res)}", flush=True)
        if cfg.family == "dense":
            assert res["kernel_vs_f32"] <= TOL["bfloat16"], res
        if whole:
            assert res["kernel_vs_f32"] <= 1.25 * res["plain_vs_f32"], res
        out.append(res)
    del params32
    torch.cuda.empty_cache()
    return out


# Device kernels by kind, matched on the kernel's name (first match wins).
KERNEL_KINDS = [
    ("flash_attention", ("fa_fwd_",)),
    ("moe_gmm", ("mg_ffn_",)),
    # the backward's kernels (and, under another checkout, PR 21's names)
    ("moe_gmm_bwd", ("mg_bwd_", "bw_gate_up_", "bw_dx_", "bw_dw_")),
    ("mamba_scan_bwd", ("msb_",)),
    ("mlstm_bwd", ("mlb_",)),
    ("mamba_scan", ("ms_ssd", "ms_cb_kernel")),
    ("mlstm", ("ml_gate_", "ml_scores", "ml_state", "ml_hout")),
    ("flash_attention_bwd", ("fa_bwd_",)),
    ("slstm", ("sl_fwd_",)),
    ("slstm_bwd", ("sl_bwd_",)),
    ("collective_codec", ("cc_select",)),
    ("gemm", ("nvjet", "gemm", "cutlass", "xmma", "sm90_")),
    ("copy_fill", ("Memcpy", "Memset", "copy_kernel", "fill_kernel")),
    ("reduce", ("reduce_kernel",)),
    ("index_scatter", ("index", "scatter", "gather", "embedding")),
    ("elementwise", ("elementwise", "softmax", "CatArray")),
]


# Launches a profile window makes before its work and leaves out of its
# counts.  In the script's long run a window lost its first device events
# (xLSTM's 1024-token prefill: 624 events without the lead, the sLSTM
# kernel of the period's first block not among them; 677 with it, of the
# lead 2 recorded: PR 29 runs 1 and 2); the lead takes that loss.
PROFILE_LEAD = 64


def profile_phase(torch, name, fn):
    """Run ``fn`` (which returns its repeat count) under torch.profiler and
    print device time by kernel, the device's busy time and idle share.
    The window opens with PROFILE_LEAD tiny spin kernels, not counted
    (``lead_events``: how many of them it recorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}            # device activity only (kernels, copies)
    lead = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if "spin_kernel" in e.name:
                lead += 1
                continue
            us, calls = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (us + e.time_range.elapsed_us(), calls + 1)
    rows = [(us, k, c) for k, (us, c) in kernels.items()]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) * 1e-6
    by_kind = {}
    for us, k, c in rows:
        kind = next((kind for kind, keys in KERNEL_KINDS
                     if any(key in k for key in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us * 1e-3 / n
    out = {"phase": name, "repeats": n, "wall_ms": wall * 1e3 / n,
           "device_ms": busy * 1e3 / n,
           "idle_share": 1.0 - busy / wall if rows else None,
           "device_events": sum(r[2] for r in rows) // n,
           "lead_events": lead,
           "by_kind_ms": by_kind,
           "top": [{"kernel": k[:60], "ms": d * 1e-3 / n,
                    "calls": c // n} for d, k, c in rows[:10]]}
    print(f"profile {json.dumps(out)}", flush=True)
    return out


def profile(torch, cfg, params, tag="", extras=None):
    """Where the time goes: device time by kernel and the device's idle
    share over one 1024-token prefill, over 8-lane decode steps and over
    the 4 x 512 fixed-batch prefill (phase names prefixed with ``tag``);
    ``extras`` as warm_up's."""
    import numpy as np

    from repro_torch.runtime.serve_loop import (ContinuousServeLoop, Request,
                                                ServeLoop)

    loop = ContinuousServeLoop(cfg, params, slots=8, max_len=MAX_LEN)
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 1024,
                                               dtype=np.int32),
                    max_new_tokens=64) for i in range(8)]
    one, fbatch = extras or (None, None)
    ex = [one(r) if one else None for r in reqs]    # before the profile
    for r, e in zip(reqs[:7], ex):
        loop.admit(r, extras=e)
    loop.decode_step()
    torch.cuda.synchronize()

    profile_phase(torch, tag + "prefill_1024",
                  lambda: (loop.admit(reqs[7], extras=ex[7]), 1)[1])
    profile_phase(torch, tag + "decode_step_8_lanes",
                  lambda: sum(1 for _ in range(10) if loop.decode_step()))
    del loop
    floop = ServeLoop(cfg, params, max_len=MAX_LEN)
    batch = [Request(rid=i, prompt=r.prompt[:512], max_new_tokens=4)
             for i, r in enumerate(reqs[:4])]
    fex = fbatch(batch) if fbatch else None
    profile_phase(torch, tag + "fixed_prefill_4x512",
                  lambda: (floop.start(batch, extras=fex), 1)[1])


# Backward tolerances (atol = rtol): the f32 sums run in another order
# over up to S x G terms (f32); bf16 adds the rounding of O inside
# D = rowsum(dO * O) and of the outputs.
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# train-check: bf16 loss and flat gradient against an f32 witness of the
# same weights (relative), and the kernel path's distance from it at most
# 1.25 times the plain path's.
TRAIN_TOL = {"loss": 1e-2, "grad": 0.1}
SHARD = 617_907_200        # one full-width shard: 1,235,814,400 / 2 data
# the fabric phases' gangs' depth: 2 of llama3.2-1b's 16 layers at full
# width (384,313,344 params, a 3.84 GB train state, most of it the
# embedding), for the script's time limit (at all 16 the phase took
# 119.9-182.7 s, most of it host passes over two 12.36 GB states; at 4
# layers 62.5-76.2 s; at 2, 58.5 s and the spot wave's 134.7 s, when each
# of its 39 checkpoints copied and hashed the state)
FABRIC_LAYERS = 2
# the ckpt phase's depth: 1 of llama3.2-1b's 16 layers at full width
# (323,491,840 params, a 3.24 GB train state, most of it the embedding),
# for the script's time limit (at all 16 the phase took 214-256 s, at 4
# layers 92.9-118.3 s, at 2 77.0 s)
CKPT_LAYERS = 1
GANG = {"ranks": 4, "pods": 2, "global_batch": 8, "seq_len": 1024,
        "frac": 0.05, "steps": 12, "lr": 1e-3}


def _fault_source(kernel, source, fault, tag):
    """A copy of ``kernels/<kernel>/csrc/<source>`` with the planted fault
    ``fault`` ((old, new), old found once), written under
    build/chip_smoke_fault/<tag>/; its path."""
    src = os.path.join(REPO, "src", "repro_torch", "kernels", kernel,
                       "csrc", source)
    with open(src) as f:
        text = f.read()
    old, new = fault
    assert text.count(old) == 1, "the planted fault's line moved"
    out = os.path.join(REPO, "build", "chip_smoke_fault", tag, source)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write(text.replace(old, new))
    return out


def _gmm_bwd_fault_source():
    """A copy of moe_gmm_bwd.cu without the product of h's low bf16 part
    in dw2 = h^T dy (h rounded once: the fault its checks must catch)."""
    from repro_torch.kernels.moe_gmm import ref as gr
    return _fault_source("moe_gmm", "moe_gmm_bwd.cu", gr.BWD_ROUND_FAULT,
                         "moe_gmm_bwd")


def _scan_bwd_fault_source(fault="carry"):
    """A copy of mamba_scan_bwd.cu with the planted fault ``fault``:
    "carry" (the gradient of the state entering a chunk drops the carry
    from the one leaving it, ``ref.BWD_CARRY_FAULT``) or "round" (the
    bf16 route's dY S_in with S_in rounded once, ``ref.BWD_ROUND_FAULT``)."""
    from repro_torch.kernels.mamba_scan import ref as sr
    return _fault_source("mamba_scan", "mamba_scan_bwd.cu",
                         {"carry": sr.BWD_CARRY_FAULT,
                          "round": sr.BWD_ROUND_FAULT}[fault],
                         "mamba_scan_bwd" + ("" if fault == "carry"
                                             else f"_{fault}"))


def _mlstm_bwd_fault_source(fault):
    """A copy of mlstm_bwd.cu with the planted fault ``fault``: "carry"
    (the reverse walk drops the carry of (dC, dn), ``ref.BWD_CARRY_FAULT``),
    "floor" (the floor's branch ignored, ``ref.BWD_FLOOR_FAULT``) or
    "round" (the bf16 route's U = dH C with C rounded once,
    ``ref.BWD_ROUND_FAULT``)."""
    from repro_torch.kernels.mlstm import ref as mr
    return _fault_source("mlstm", "mlstm_bwd.cu",
                         {"carry": mr.BWD_CARRY_FAULT,
                          "floor": mr.BWD_FLOOR_FAULT,
                          "round": mr.BWD_ROUND_FAULT}[fault],
                         f"mlstm_bwd_{fault}")


def _mlstm_parts_fault_source():
    """A copy of mlstm.cu with its f32 operands in two bf16 parts
    (``ref.FWD_PARTS_FAULT``: the forward as it was before three parts),
    which the forward's precision row must fail."""
    from repro_torch.kernels.mlstm import ref as mr
    return _fault_source("mlstm", "mlstm.cu", mr.FWD_PARTS_FAULT,
                         "mlstm_parts")


def _scan_carry_fault_source():
    """A copy of mamba_scan.cu that carries no state from one chunk into
    the next (``ref.FWD_CARRY_FAULT``), which the long scan's row must
    fail."""
    from repro_torch.kernels.mamba_scan import ref as sr
    return _fault_source("mamba_scan", "mamba_scan.cu", sr.FWD_CARRY_FAULT,
                         "mamba_scan_carry")


def _flash_rescale_fault_source():
    """A copy of flash_attention.cu whose bf16 route does not rescale the
    running sum and accumulator when a row's maximum rises
    (``ref.FWD_RESCALE_FAULT``), which the long flash row must fail."""
    from repro_torch.kernels.flash_attention import ref as fr
    return _fault_source("flash_attention", "flash_attention.cu",
                         fr.FWD_RESCALE_FAULT, "flash_attention_rescale")


def _ptxas(name):
    """ptxas's registers and spills for each kernel of the library
    ``name`` (its last build's log): {kernel: "N registers, S bytes spill
    stores, L bytes spill loads"}."""
    from repro_torch.kernels import _build

    out, kern, spill = {}, None, ""
    for ln in _build.build_logs.get(name, "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?_Z\w*?(m[ls]b_\w+?_kernel)((?:ILb[01]E)?"
                      r"(?:Lb[01]E)*)", ln)
        if m:             # a template instance's bools: <1,0>
            args = ",".join(re.findall(r"Lb([01])E", m.group(2)))
            kern = m.group(1) + (f"<{args}>" if args else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"{m.group(1)} bytes spill stores, {m.group(2)} loads"
        m = re.search(r"Used (\d+) registers", ln)
        if m and kern:
            out[kern] = f"{m.group(1)} registers, {spill}"
    return out


def build_all(torch):
    """Build every kernel source with nvcc, one process each, all started
    together (and the planted-fault copies of the backward kernels, which
    their checks must fail); print each build's time and ptxas registers
    and spills."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    from repro_torch.kernels.collective_codec import ops as co
    from repro_torch.kernels.diff_merge import ops as dm
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mlstm import ops as ml_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.slstm import ops as sl_ops

    src = os.path.join(REPO, "src", "repro_torch", "kernels")
    jobs = {"flash_attention": os.path.join(
                src, "flash_attention", "csrc", "flash_attention.cu"),
            "flash_attention_bwd": os.path.join(
                src, "flash_attention", "csrc", "flash_attention_bwd.cu"),
            "collective_codec": os.path.join(
                src, "collective_codec", "csrc", "collective_codec.cu"),
            "diff_merge": os.path.join(
                src, "diff_merge", "csrc", "diff_merge.cu"),
            "moe_gmm": os.path.join(src, "moe_gmm", "csrc", "moe_gmm.cu"),
            "moe_gmm_bwd": os.path.join(src, "moe_gmm", "csrc",
                                        "moe_gmm_bwd.cu"),
            "moe_gmm_bwd_fault": _gmm_bwd_fault_source(),
            "mamba_scan": os.path.join(
                src, "mamba_scan", "csrc", "mamba_scan.cu"),
            "mamba_scan_bwd": os.path.join(
                src, "mamba_scan", "csrc", "mamba_scan_bwd.cu"),
            "mamba_scan_carry_fault": _scan_carry_fault_source(),
            "flash_attention_rescale_fault": _flash_rescale_fault_source(),
            "mamba_scan_bwd_fault": _scan_bwd_fault_source(),
            "mamba_scan_bwd_round_fault": _scan_bwd_fault_source("round"),
            "mlstm": os.path.join(src, "mlstm", "csrc", "mlstm.cu"),
            "mlstm_parts_fault": _mlstm_parts_fault_source(),
            "mlstm_bwd": os.path.join(src, "mlstm", "csrc", "mlstm_bwd.cu"),
            "mlstm_bwd_carry_fault": _mlstm_bwd_fault_source("carry"),
            "mlstm_bwd_floor_fault": _mlstm_bwd_fault_source("floor"),
            "mlstm_bwd_round_fault": _mlstm_bwd_fault_source("round"),
            "slstm": os.path.join(src, "slstm", "csrc", "slstm.cu"),
            "slstm_bwd": os.path.join(src, "slstm", "csrc", "slstm_bwd.cu"),
            "slstm_layout_fault": _slstm_fault_source("layout"),
            "slstm_rescale_fault": _slstm_fault_source("rescale"),
            "slstm_exchange_fault": _slstm_fault_source("exchange"),
            "slstm_bwd_carry_fault": _slstm_fault_source("carry")}

    def one(name):
        t0 = time.perf_counter()
        _build.build(name, jobs[name])
        return time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        secs = dict(zip(jobs, pool.map(one, jobs)))
    fa_ops.fwd_lib()
    fa_ops.bwd_lib()
    co.lib()
    dm.lib()
    gmm_ops.lib()
    gmm_ops.bwd_lib()
    scan_ops.lib()
    scan_ops.bwd_lib()
    ml_ops.lib()
    ml_ops.bwd_lib()
    sl_ops.lib()
    sl_ops.bwd_lib()
    for name in jobs:
        ptxas = [ln.strip() for ln in _build.build_logs.get(name, "")
                 .splitlines() if "registers" in ln or "spill" in ln]
        print(f"build {name} {secs[name]:.1f}s {json.dumps(ptxas)}",
              flush=True)
    print(f"build all {time.perf_counter() - t0:.1f}s", flush=True)


def check_codec(torch, co, cr):
    """The codec kernel against its plain version, bit for bit: small
    shapes of the JAX tests, one full-width shard at frac 0.05
    (30,895,360 x 20) and at frac 1.0 (617,907,200 x 1), and the main
    path's one launch over the 4 shards of a step (123,581,440 x 20).
    Times: kernel, plain version, and ``torch.max(x.abs(), dim=1)``, the
    nearest PyTorch call (partial: no column of the first maximum's
    value, no residual)."""
    k_shard = co.codec_geometry(SHARD, GANG["frac"])[0]
    cases = [(8, 16), (24, 33), (16, 1), (1, 64), (k_shard, 20),
             (SHARD, 1), (GANG["ranks"] * k_shard, 20)]
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for k, m in cases:
        x = torch.randn((k, m), generator=gen, device="cuda")
        x[:min(k, 4096)] = torch.round(x[:min(k, 4096)] * 2)   # ties
        vals, col, resid = co.chunk_select(x)
        exact = True
        step = max(1, k // 8)
        for lo in range(0, k, step):            # the plain version in parts
            rv, rc, rr = cr.chunk_select_ref(x[lo:lo + step])
            exact &= bool(torch.equal(vals[lo:lo + step], rv)
                          & torch.equal(col[lo:lo + step], rc)
                          & torch.equal(resid[lo:lo + step], rr))
            del rv, rc, rr
        torch.cuda.synchronize()
        del vals, col, resid
        big = k * m > 1 << 20
        ms = _time_ms(lambda: co.chunk_select(x), iters=5 if big else 20)
        plain_ms = _time_ms(lambda: cr.chunk_select_ref(x),
                            iters=2 if big else 5, warmup=1)
        partial_ms = _time_ms(lambda: torch.max(x.abs(), dim=1),
                              iters=5 if big else 20)
        nbytes = co.work(k, m)[1]
        row = {"rows": k, "m": m, "bit_exact": exact, "max_abs_err": 0.0
               if exact else None, "ms": ms, "plain_ms": plain_ms,
               "library_ms": None, "nearest_call_ms_partial": partial_ms,
               "nearest_call": "torch.max(x.abs(), dim=1)",
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "gbytes_per_s": nbytes / ms * 1e-6}
        rows.append(row)
        print(f"kernel-check codec {json.dumps(row)}", flush=True)
        del x
        torch.cuda.empty_cache()
    co.reset_launches()
    return rows


DM_OPS = ("sum", "subtract", "multiply", "divide", "overwrite")
EMBED_N = 128256 * 2048            # the full-width embedding's elements


def _dm_inputs(torch, shape, dtype, op, seed):
    """a0, b0 and b1 = b0 with some elements changed; float cases with 3+
    chunks also get a clean chunk holding a -0 / +0 pair and a NaN in b0
    and b1 (a dirty chunk)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if dtype.is_floating_point:
        a0, b0 = ((torch.randn(shape, generator=gen, device="cuda") + 2.0)
                  .to(dtype) for _ in range(2))
    else:
        lo = 1 if op in ("multiply", "divide") else -2 ** 20
        a0, b0 = (torch.randint(lo, 2 ** 20, shape, generator=gen,
                                device="cuda", dtype=dtype)
                  for _ in range(2))
    b1 = b0.clone()
    flat = b1.view(-1)
    flat[::97] *= 3
    flat[5:40] += 7
    if dtype.is_floating_point and flat.numel() > 3 * 1024:
        b0.view(-1)[2048 + 9] = float("nan")
        flat[2048 + 9] = float("nan")
        flat[1024:2048] = b0.view(-1)[1024:2048]
        b0.view(-1)[1024 + 7] = 0.0
        flat[1024 + 7] = -0.0
    return a0, b0, b1


def _dm_same(torch, x, y):
    """Bit for bit where not NaN, NaN where NaN (a NaN's payload is not
    part of the function)."""
    if not x.dtype.is_floating_point:
        return bool(torch.equal(x, y))
    nan = torch.isnan(x)
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    return bool(torch.equal(nan, torch.isnan(y))
                and torch.equal(x.view(view)[~nan], y.view(view)[~nan]))


def _dm_bytes(n, esize):
    """Least traffic of one fused pass (diff_merge/ops.py ``work``)."""
    from repro_torch.kernels.diff_merge import ops
    return ops.work(n, esize)[1]


def check_diff_merge(torch, dm, dr):
    """diff_merge against its plain version, bit for bit (values and dirty
    masks): every op over bf16, f32, f64 and int32 (int64 for the exact
    ops) at the JAX tests' shapes (32 x 1024, 13 x 77, a ragged 3333),
    the JAX tests' own cases (16 x 1024 int32, 3000 f64 with a 1e-12
    step), NaN and -0 chunks, and an int32 leaf above 2^24 under
    multiply (clean chunks round through f32).  Then timed at the
    embedding's size (128256 x 2048) in bf16 (the params) and f32 (a
    moment), 5% and 100% of the chunks dirty, sum and overwrite: the
    kernel, the plain version, and ``(b0 != b1).view(-1, 1024).any(1)``,
    the nearest PyTorch call (partial: the dirty mask only)."""
    dtypes = [torch.bfloat16, torch.float32, torch.float64, torch.int32,
              torch.int64]
    cases, bad = 0, []
    for op in DM_OPS:
        for dt in dtypes:
            if dt == torch.int64 and op in ("multiply", "divide"):
                continue
            for shape in [(32, 1024), (13, 77), (3333,)]:
                a0, b0, b1 = _dm_inputs(torch, shape, dt, op, cases)
                out, dirty = dm.diff_merge_leaf(a0, b0, b1, op=op)
                rout, rdirty = dr.diff_merge_leaf_ref(a0, b0, b1, op=op)
                cases += 1
                if not (_dm_same(torch, out, rout)
                        and torch.equal(dirty, rdirty)):
                    bad.append([op, str(dt), shape])
    # the JAX tests' own inputs, and the int32 rounding of clean chunks
    a0 = torch.randint(-2 ** 30, 2 ** 30, (16, 1024), device="cuda",
                       dtype=torch.int32)
    b1 = a0.clone()
    b1[3:5] += 7
    out, dirty = dm.diff_merge_leaf(a0, a0.clone(), b1, op="sum")
    want = a0.clone()
    want[3:5] += 7
    exact_int = bool(torch.equal(out, want)) and int(dirty.sum()) == 2
    a0 = torch.full((3000,), 1.0, dtype=torch.float64, device="cuda")
    b1 = a0.clone()
    b1[:1024] += 1e-12
    out, dirty = dm.diff_merge_leaf(a0, a0.clone(), b1, op="sum")
    exact_f64 = bool(torch.equal(out, b1)) and dirty.tolist() == \
        [True, False, False]
    big = torch.full((2, 1024), 2 ** 24 + 1, dtype=torch.int32,
                     device="cuda")
    b0 = torch.full_like(big, 4)
    b1 = b0.clone()
    b1[1, 0] = 8
    out, dirty = dm.diff_merge_leaf(big, b0, b1, op="multiply")
    rout, rdirty = dr.diff_merge_leaf_ref(big, b0, b1, op="multiply")
    rounding = bool(torch.equal(out, rout) and (out[0] == 2 ** 24).all()
                    and torch.equal(dirty, rdirty))
    torch.cuda.synchronize()
    res = {"cases": cases + 3, "bit_exact": cases - len(bad)
           + exact_int + exact_f64 + rounding, "failed": bad,
           "int32_16x1024": exact_int, "f64_3000": exact_f64,
           "int32_clean_rounding": rounding}
    print(f"kernel-check diff_merge {json.dumps(res)}", flush=True)
    assert not bad and exact_int and exact_f64 and rounding, res

    rows = []
    for dt in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(11)
        a0 = torch.randn((EMBED_N,), generator=gen, device="cuda").to(dt)
        b0 = torch.randn((EMBED_N,), generator=gen, device="cuda").to(dt)
        for share in (0.05, 1.0):
            b1 = b0.clone()
            b1.view(-1, 1024)[::round(1 / share), 0] += 1
            for op in ("sum", "overwrite"):
                out, dirty = dm._launch(a0, b0, b1, op)
                rout, rdirty = dr.diff_merge_leaf_ref(a0, b0, b1, op=op)
                exact = _dm_same(torch, out, rout) and bool(
                    torch.equal(dirty, rdirty))
                del out, dirty, rout, rdirty
                ms = _time_ms(lambda: dm._launch(a0, b0, b1, op), iters=10)
                plain_ms = _time_ms(lambda: dr.diff_merge_leaf_ref(
                    a0, b0, b1, op=op), iters=3, warmup=1)
                near_ms = _time_ms(lambda: (b0 != b1).view(-1, 1024).any(1),
                                   iters=10)
                nbytes = _dm_bytes(EMBED_N, a0.element_size())
                row = {"n": EMBED_N, "dtype": str(dt).split(".")[-1],
                       "dirty_share": share, "op": op, "bit_exact": exact,
                       "max_abs_err": 0.0 if exact else None, "ms": ms,
                       "plain_ms": plain_ms, "library_ms": None,
                       "nearest_call_ms_partial": near_ms,
                       "nearest_call": "(b0 != b1).view(-1, 1024).any(1)",
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                       "bound_by": "bytes",
                       "gbytes_per_s": nbytes / ms * 1e-6}
                rows.append(row)
                print(f"kernel-check diff_merge {json.dumps(row)}",
                      flush=True)
            del b1
        del a0, b0
        torch.cuda.empty_cache()
    dm.reset_launches()
    assert all(r["bit_exact"] for r in rows), rows
    return rows


def _bwd_bound(b, h, kv, s, hd, window, dtype_name, esize):
    """Least time of the causal attention's backward (``bwd_work``)."""
    from repro_torch.kernels.flash_attention import ops
    flops, nbytes = ops.bwd_work(b, h, kv, s, hd, True, window, esize)
    return (*_roof(flops, nbytes, dtype_name), flops)


def check_backward(torch, fa_ops, fa_ref, F):
    """dq, dk, dv of the backward kernel against autograd of the plain
    version, at the training shape (B=2, S=1024) and the serve checks'
    shapes (ragged S=1000, window 256, hd=80 padded, B=4 x 512) of H 32 /
    KV 8, and at the rank batches of the train families' phase:
    whisper-small's (group 1: H 12 / KV 12, 2 x 448),
    granite-moe-1b-a400m's (group 2: H 16 / KV 8, 4 x 1024) and
    llama-3.2-vision-11b's (hd 128, 1 x 1024), bf16 and f32.  Times
    (backward only, inputs in the kernel layout): the kernel, autograd of
    the plain version, and the backward of
    ``scaled_dot_product_attention`` (the library yardstick)."""
    cases = [(2, 1024, 64, 0, 32, 8), (1, 1000, 64, 0, 32, 8),
             (1, 1024, 64, 256, 32, 8), (1, 1024, 80, 0, 32, 8),
             (4, 512, 64, 0, 32, 8), (2, 448, 64, 0, 12, 12),
             (4, 1024, 64, 0, 16, 8), (1, 1024, 128, 0, 32, 8)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for b, s, hd, window, h, kv in cases:
        for dname in ("bfloat16", "float32"):
            dt = getattr(torch, dname)
            tol = BWD_TOL[dname]
            q, k, v = (torch.randn((b, s, n, hd), generator=gen,
                                   device="cuda").to(dt).requires_grad_()
                       for n in (h, kv, kv))
            dout = torch.randn((b, s, h, hd), generator=gen,
                               device="cuda").to(dt)
            out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
            grads = torch.autograd.grad(out, (q, k, v), dout)
            ref = fa_ref.attention_ref(*(x.transpose(1, 2) for x in
                                         (q, k, v)), causal=True,
                                       window=window).transpose(1, 2)
            rgrads = torch.autograd.grad(ref, (q, k, v), dout)
            torch.cuda.synchronize()
            errs = [(g.float() - r.float()).abs().max().item()
                    for g, r in zip(grads, rgrads)]
            ok = all(bool(torch.isfinite(g.float()).all()) and
                     torch.allclose(g.float(), r.float(), atol=tol, rtol=tol)
                     for g, r in zip(grads, rgrads))
            row = {"B": b, "S": s, "H": h, "KV": kv, "hd": hd,
                   "window": window,
                   "dtype": dname, "max_abs_err_dq_dk_dv": errs,
                   "max_abs_err": max(errs), "tol": tol, "ok": ok}
            del out, grads, ref, rgrads
            if hd in (64, 128):
                scale = hd ** -0.5
                qt, kt, vt = (x.detach().transpose(1, 2).contiguous()
                              for x in (q, k, v))
                dot = dout.transpose(1, 2).contiguous()
                _, lse, o = fa_ops._launch(qt, kt, vt, causal=True,
                                           window=window, scale=scale,
                                           with_lse=True)
                ms = _time_ms(lambda: fa_ops._launch_bwd(
                    qt, kt, vt, o, lse, dot, causal=True, window=window,
                    scale=scale), iters=10)
                leaves = tuple(t.clone().requires_grad_()
                               for t in (qt, kt, vt))
                ro = fa_ref.attention_ref(*leaves, causal=True,
                                          window=window)
                plain_ms = _time_ms(lambda: torch.autograd.grad(
                    ro, leaves, dot, retain_graph=True), iters=3, warmup=1)
                del ro
                mask = None
                if window:
                    i = torch.arange(s, device="cuda")
                    mask = (i[:, None] >= i[None, :]) & \
                        (i[:, None] - i[None, :] < window)
                try:
                    so = F.scaled_dot_product_attention(
                        *leaves, attn_mask=mask, is_causal=mask is None,
                        enable_gqa=True)
                    lib_ms = _time_ms(lambda: torch.autograd.grad(
                        so, leaves, dot, retain_graph=True), iters=10)
                    del so
                except RuntimeError as e:  # the yardstick only
                    print(f"library call unavailable: {e}", flush=True)
                    lib_ms = None
                bound_ms, bound_by, flops = _bwd_bound(
                    b, h, kv, s, hd, window, dname, q.element_size())
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           tflops=flops / (ms * 1e-3) / 1e12)
            rows.append(row)
            print(f"kernel-check bwd {json.dumps(row)}", flush=True)
    fa_ops.reset_launches()
    torch.cuda.empty_cache()
    return rows


def _rank_batch(torch, cfg, rank):
    from repro_torch.data import pipeline as dp
    dcfg = dp.DataConfig(vocab=cfg.vocab, seq_len=GANG["seq_len"],
                         global_batch=GANG["global_batch"])
    batch = dp.shard_slice(dp.make_batch(dcfg, 0), rank, GANG["ranks"])
    return {k: v.cuda() for k, v in batch.items()}


def train_check(torch, cfg, params):
    """One full-width micro-batch (2 x 1024 tokens): loss and flat
    gradient through the kernel path and the plain path, both bf16, each
    against an f32 witness (the same weights cast to f32, plain path)."""
    from repro_torch.core.collectives import flatten_tree
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import attention as attn
    from repro_torch.models import model as model_mod
    from repro_torch.weights import tree_map

    grad_fn = model_mod.make_grad_fn(cfg)
    batch = _rank_batch(torch, cfg, 0)

    def run(p, plain):
        before = (fa_ops.launches, fa_ops.bwd_launches)
        if plain:
            with mock.patch.object(attn, "causal_attention",
                                   attn.plain_causal_attention):
                (loss, _), g = grad_fn(p, batch)
            assert (fa_ops.launches, fa_ops.bwd_launches) == before
        else:
            (loss, _), g = grad_fn(p, batch)
            assert fa_ops.launches > before[0] and \
                fa_ops.bwd_launches > before[1]
        vec = flatten_tree(g)[0]
        del g
        torch.cuda.synchronize()
        return float(loss), vec

    lk, gk = run(params, False)
    lp, gp = run(params, True)
    params32 = tree_map(lambda t: t.float(), params)
    lw, gw = run(params32, True)
    del params32

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()
    res = {"loss_kernel": lk, "loss_plain": lp, "loss_f32": lw,
           "loss_kernel_vs_f32": abs(lk - lw) / abs(lw),
           "loss_plain_vs_f32": abs(lp - lw) / abs(lw),
           "grad_kernel_vs_f32": rel(gk, gw),
           "grad_plain_vs_f32": rel(gp, gw),
           "grad_kernel_vs_plain": rel(gk, gp),
           "grad_norm_f32": gw.norm().item(),
           "finite": bool(torch.isfinite(gk).all()), "tol": TRAIN_TOL}
    res["ratio"] = res["grad_kernel_vs_f32"] / res["grad_plain_vs_f32"]
    print(f"train-check {json.dumps(res)}", flush=True)
    del gk, gp, gw
    torch.cuda.empty_cache()
    assert res["finite"], res
    assert res["loss_kernel_vs_f32"] <= TRAIN_TOL["loss"], res
    assert res["grad_kernel_vs_f32"] <= TRAIN_TOL["grad"], res
    assert res["ratio"] <= 1.25, res
    return res


def sync_check(torch, cfg, params):
    """One full-width step's per-rank gradients (4 ranks, 2 pods) through
    every schedule, compared as f32 mean vectors: compressed at frac 1.0
    bit-identical to hierarchical, flat and ring within 1e-6 (relative
    L2) of it."""
    from repro_torch.core import collectives as coll
    from repro_torch.models import model as model_mod

    grad_fn = model_mod.make_grad_fn(cfg)
    grads = [grad_fn(params, _rank_batch(torch, cfg, r))[1]
             for r in range(GANG["ranks"])]
    n_ranks, pods = GANG["ranks"], GANG["pods"]
    data = n_ranks // pods

    def vectors():              # one f32 vector at a time
        for g in grads:
            yield coll.flatten_tree(g, pad_to=n_ranks)[0]

    def sync(mode, frac=None):
        resid = (coll.init_residual_buffer(grads[0], pods, data)
                 if mode == "compressed" else None)
        t0 = time.perf_counter()
        out, new = coll.tree_sync(vectors(), mode, pods, data, frac, resid)
        torch.cuda.synchronize()
        return out, new, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    hier, _, t_hier = sync("hierarchical")
    comp, new, t_comp = sync("compressed", 1.0)
    res = {"n": hier.numel(), "bit_identical": bool(torch.equal(hier, comp)),
           "residual_zero": not bool(new.any()),
           "wall_s": {"hierarchical": t_hier, "compressed_1.0": t_comp}}
    del comp, new
    for mode in ("flat", "ring"):
        out, _, t = sync(mode)
        res[f"{mode}_vs_hierarchical"] = ((out - hier).norm()
                                          / hier.norm()).item()
        res["wall_s"][mode] = t
        del out
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"sync-check {json.dumps(res)}", flush=True)
    del grads, hier
    torch.cuda.empty_cache()
    assert res["bit_identical"] and res["residual_zero"], res
    assert res["flat_vs_hierarchical"] <= 1e-6, res
    assert res["ring_vs_hierarchical"] <= 1e-6, res
    return res


def train_anatomy(torch, cfg, ocfg, dcfg, state):
    """Wall time of one gang step's parts, with the device synchronised
    between them: each rank's forward and backward, the gradient sync
    (flattening into the pods' shards, the codec, the merge), AdamW."""
    from repro_torch.core import collectives as coll
    from repro_torch.data import pipeline as dp
    from repro_torch.models import model as model_mod
    from repro_torch.optim import adamw

    n_ranks, pods = GANG["ranks"], GANG["pods"]
    grad_fn = model_mod.make_grad_fn(cfg)
    batch = {k: v.cuda() for k, v in dp.make_batch(dcfg, 0).items()}
    resid = coll.init_residual_buffer(state["params"], pods,
                                      n_ranks // pods)
    grad_ms = []

    def rank_grads():
        for r in range(n_ranks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = grad_fn(state["params"], dp.shard_slice(batch, r,
                                                        n_ranks))[1]
            torch.cuda.synchronize()
            grad_ms.append((time.perf_counter() - t0) * 1e3)
            yield g
            del g
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads, resid = coll.tree_sync(rank_grads(), "compressed", pods,
                                  n_ranks // pods, GANG["frac"], resid)
    torch.cuda.synchronize()
    sync_ms = (time.perf_counter() - t0) * 1e3 - sum(grad_ms)
    del resid
    t0 = time.perf_counter()
    adamw.apply(grads, state["opt"], state["params"], ocfg)
    torch.cuda.synchronize()
    res = {"grad_ms": grad_ms, "sync_ms": sync_ms,
           "adamw_ms": (time.perf_counter() - t0) * 1e3}
    print(f"train-anatomy {json.dumps(res)}", flush=True)
    del grads
    torch.cuda.empty_cache()
    return res


def train(torch, cfg, state_bytes):
    """The port's training path: ``FaabricTrainRuntime`` over 4 virtual
    ranks in 2 pods, compressed sync at frac 0.05, global batch 8 x 1024
    tokens, from seeded random weights.  Kernel counts are set to 0 just
    before the run and read just after.  The runtime saves the state
    before step 0 (blocking), as the JAX runtime does; its time is in
    the run's wall time and reported as ``ckpt_step0_s``."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels.collective_codec import ops as co
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import (FaabricTrainRuntime,
                                                RuntimeConfig)

    steps = GANG["steps"]
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=GANG["seq_len"],
                      global_batch=GANG["global_batch"])
    ocfg = AdamWConfig(lr=GANG["lr"], warmup_steps=max(steps // 10, 1),
                       total_steps=steps)
    _disk_check(state_bytes)
    rt = RuntimeConfig(total_steps=steps, sync_mode="compressed",
                       compress_frac=GANG["frac"], pods=GANG["pods"],
                       checkpoint_every=0,
                       ckpt_dir=os.path.join(CKPT_ROOT, "train"))
    runtime = FaabricTrainRuntime(cfg, ocfg, dcfg, rt, ranks=GANG["ranks"],
                                  device="cuda")
    state = runtime.init_state(seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.reset_launches()
    co.reset_launches()
    t0 = time.perf_counter()
    state, out = runtime.run(state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa_ops.launches,
                "flash_attention_bwd": fa_ops.bwd_launches,
                "collective_codec": co.launches}
    losses = out["losses"]
    times = [e["time"] for e in out["log"]]
    warm = sorted(times[1:])

    def pct(q):
        return warm[min(len(warm) - 1, int(math.ceil(q / 100 * len(warm)))
                        - 1)]
    tokens = GANG["global_batch"] * GANG["seq_len"]
    shutil.rmtree(os.path.join(CKPT_ROOT, "train"))
    res = {"steps": len(losses), "losses": losses,
           "ckpt_step0_s": runtime.ckpt.stats[0]["device_to_host_s"],
           "first_step_s": times[0], "step_s_p50": pct(50),
           "step_s_p99": pct(99), "wall_s": wall,
           "tokens_per_s": tokens * len(losses) / wall,
           "tokens_per_s_warm": tokens / pct(50),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "gang": GANG}
    print(f"train {json.dumps(res)}", flush=True)
    assert len(losses) >= 10 and all(math.isfinite(x) for x in losses), res
    assert losses[-1] < losses[0], res
    per_step = {"flash_attention": 2 * cfg.n_layers * GANG["ranks"],
                "flash_attention_bwd": cfg.n_layers * GANG["ranks"],
                "collective_codec": 1}
    for name, n in per_step.items():
        assert launches[name] == n * steps, (name, launches, per_step)

    train_anatomy(torch, cfg, ocfg, dcfg, state)
    # one gang step as the runtime runs it (its batch on the card first)
    from repro_torch.core import collectives as coll
    from repro_torch.data import pipeline as dp
    step_fn = _gang_step(torch, cfg, ocfg, GANG["frac"])
    batch = {k: v.cuda() for k, v in dp.make_batch(dcfg, 0).items()}
    resid = coll.init_residual_buffer(state["params"], GANG["pods"],
                                      GANG["ranks"] // GANG["pods"])

    def one_step():
        float(step_fn(state, batch, resid)[1]["loss"])
        return 1
    profile_phase(torch, "train_step", one_step)
    del state, runtime, batch, resid
    torch.cuda.empty_cache()
    return res, launches


# The dryrun phase (slice 15; the JAX package's assigned shapes since
# slice 17): each cell's step analysed on the meta device (launch.dryrun,
# H100 constants), then run for real at full width and depth: (name, arch,
# shape, batch, why the batch is cut).  A shape is one of
# configs.base.SHAPES, its global batch cut to ``batch`` only as far as
# the card's 80 GB or the script's time limit force; a train_4k step
# micro-batches by launch.dryrun.GRAD_ACCUM.  "flash" is the flash
# kernels' forward and backward alone at 2 x 1024, llama's shape of the
# train phase (where the saved lse and f32 output are a large share of
# the peak, so that an analysis that forgets them fails the memory gate).
_TIME = "the script's time limit (a step is linear in the batch)"
DRYRUN_CELLS = [
    ("train_4k-llama1b", "llama3.2-1b", "train_4k", 4, _TIME),
    ("train_4k-llama3b", "llama3.2-3b", "train_4k", 2,
     _TIME + "; a 32.1 GB train state and its f32 gradient sum"),
    ("train_4k-granite", "granite-moe-1b-a400m", "train_4k", 2, _TIME),
    ("train_4k-xlstm", "xlstm-1.3b", "train_4k", 4, _TIME),
    ("prefill_32k-llama1b", "llama3.2-1b", "prefill_32k", 2, _TIME),
    ("prefill_32k-glm9b", "glm4-9b", "prefill_32k", 1, _TIME),
    ("prefill_32k-zamba2", "zamba2-2.7b", "prefill_32k", 1, _TIME),
    ("prefill_32k-xlstm", "xlstm-1.3b", "prefill_32k", 1, _TIME),
    ("decode_32k-llama1b", "llama3.2-1b", "decode_32k", 48,
     "80 GB: 1.07 GB of KV cache a sequence"),
    ("decode_32k-minitron4b", "minitron-4b", "decode_32k", 12,
     "80 GB: 4.29 GB of KV cache a sequence"),
    ("decode_32k-xlstm", "xlstm-1.3b", "decode_32k", 100,
     "80 GB: 0.70 GB of mLSTM state a sequence (the analysis predicts a "
     "74.7 GB peak at 100, 77.6 at 104)"),
    ("long_500k-zamba2", "zamba2-2.7b", "long_500k", 1, None),
    ("long_500k-xlstm", "xlstm-1.3b", "long_500k", 1, None),
    ("flash", "llama3.2-1b", "flash", 2, None)]
DRYRUN_STEPS = 3                   # timed steps, after one warm step
# A step whose warm run takes this long or longer is timed once: the
# spread of three such steps was under 3.4% (glm4-9b's and xlstm's
# prefill_32k under 0.2%, xlstm's train_4k 3.4%; PR 28 runs 2-4), and
# their repeats were ~25 s of the script's time limit.  1.5 s since PR 29,
# whose sLSTM kernels brought xlstm's prefill_32k step to 1.85 s.
DRYRUN_LONG_S = 1.5
DRYRUN_FLASH_STEPS = 5             # the flash cell's (a step is ~1 ms)
DRYRUN_FAKE_WORKERS = 3            # processes tracing on fake CUDA
DRYRUN_MEM_TOL = 0.10              # predicted peak against the measured


def _flash_step(q, k, v):
    """The gradients of q, k, v through the causal flash kernels under a
    sum loss."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    with torch.enable_grad():
        ts = [t.detach().requires_grad_() for t in (q, k, v)]
        loss = fa_ops.flash_attention(*ts).float().sum()
        return torch.autograd.grad(loss, ts)


def dryrun_cell(torch, cell, device, remat=True, cfg=None):
    """(cfg, shape, step, its meta arguments, a maker of the same
    arguments on ``device``) of one DRYRUN_CELLS entry; ``shape`` is a
    ShapeConfig with the JAX shape's name and length and the cell's batch
    (kind "flash" for the flash cell).  ``cfg`` stands in for the arch's
    full config (a reduced one, on the CPU).  A decode cell's state is
    ``tf.init_decode_state`` at the shape's window, every KV row drawn
    from a seeded normal in the model's dtype, and its position is
    ``seq_len - 1``, where every row is attended (a long_500k ring has
    wrapped 127 times)."""
    from repro_torch.configs.base import SHAPES, ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig

    _, arch, shape_name, b = cell[:4]
    cfg = (cfg or get_config(arch)).with_(remat=remat)
    gen = lambda seed=15: torch.Generator(device=device).manual_seed(seed)
    if shape_name == "flash":
        shape = ShapeConfig("flash", 1024, b, "flash")

        def make_flash(dev):
            draw = torch.empty if dev == "meta" else torch.randn
            return tuple(draw((b, shape.seq_len, h, cfg.hd()), device=dev,
                              dtype=cfg.torch_dtype())
                         for h in (cfg.n_heads, cfg.n_kv_heads,
                                   cfg.n_kv_heads))
        return cfg, shape, _flash_step, make_flash("meta"), \
            lambda: make_flash(device)
    jax_shape = SHAPES[shape_name]
    shape = ShapeConfig(jax_shape.name, jax_shape.seq_len, b, jax_shape.kind)
    s = shape.seq_len
    accum = dr.GRAD_ACCUM[arch] if shape.name == "train_4k" else 1
    mesh = make_host_mesh((1, 1), ("data", "model"))
    fn, args, _ = dr.build_cell(cfg, shape, mesh, grad_accum=accum)

    def tokens(n):
        return torch.randint(0, cfg.vocab, (b, n), generator=gen(),
                             device=device, dtype=torch.int32)
    if shape.kind == "train":
        def make():
            state = model_mod.init_train_state(gen(), cfg, AdamWConfig(),
                                               device=device)
            return state, {"tokens": tokens(s), "labels": tokens(s)}
    elif shape.kind == "prefill":
        def make():
            return (tf.init_params(gen(), cfg, device=device),
                    {"tokens": tokens(s)})
    else:
        def make():
            states = tf.init_decode_state(
                cfg, b, s, cfg.torch_dtype(),
                window=model_mod.decode_window(cfg, shape), device=device)
            draw = gen(16)
            for st in states:
                for key in ("k", "v"):
                    if key in st:
                        st[key].normal_(generator=draw)
            pos = torch.full((b, 1), s - 1, dtype=torch.int32, device=device)
            return (tf.init_params(gen(), cfg, device=device), states,
                    tokens(1), pos)
    return cfg, shape, fn, args, make


def dryrun_predict(torch, fn, args, kind):
    """The step's analysis on the meta device (card routes)."""
    from repro_torch.launch import dryrun as dr
    return dr.trace(fn, args, kind in ("train", "flash"))


def dryrun_predict_fake(torch, fn, meta_args, kind):
    """The same analysis on fake CUDA tensors (a CUDA build of PyTorch
    traces their backward; a CPU-only one cannot)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun as dr
    from repro_torch.weights import tree_map
    with FakeTensorMode():
        args = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="cuda")
                        if isinstance(t, torch.Tensor) else t, meta_args)
        return dr.trace(fn, args, kind in ("train", "flash"))


def _fake_trace_cell(index):
    """The analysis of DRYRUN_CELLS[index]'s step on fake CUDA tensors
    (``dryrun_predict_fake``) and its seconds."""
    import torch
    _, shape, fn, meta_args, _ = dryrun_cell(torch, DRYRUN_CELLS[index],
                                             "cuda")
    t0 = time.perf_counter()
    fake = dryrun_predict_fake(torch, fn, meta_args, shape.kind)
    return fake, time.perf_counter() - t0


def _fake_worker(tasks, results):
    """A worker process of ``_FakeTraces``: each cell index from
    ``tasks`` to (index, its ``_fake_trace_cell``, or the error) on
    ``results``, until None."""
    for index in iter(tasks.get, None):
        try:
            results.put((index, _fake_trace_cell(index)))
        except Exception as e:            # reported to the main process
            results.put((index, RuntimeError(f"fake trace: {e!r}")))


class _FakeTraces:
    """DRYRUN_CELLS' analyses on fake CUDA tensors, the ``dryrun`` phase's
    largest host cost (~100 s, train_4k-xlstm's ~45 of it), from
    DRYRUN_FAKE_WORKERS spawned worker processes that run beside the main
    one from the phase's start.  They are stopped (SIGSTOP) while the main
    process times a step (``paused``), so that they take no host time from
    it."""

    def __init__(self, workers):
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        self.tasks, self.results = ctx.Queue(), ctx.Queue()
        self.procs = [ctx.Process(target=_fake_worker,
                                  args=(self.tasks, self.results))
                      for _ in range(workers)]
        # train_4k-xlstm's trace, the longest by far, first: the main
        # process needs it fourth, the first cells' soon after they start
        first = [i for i, c in enumerate(DRYRUN_CELLS)
                 if c[0] == "train_4k-xlstm"]
        for index in first + [i for i in range(len(DRYRUN_CELLS))
                              if i not in first]:
            self.tasks.put(index)
        for _ in self.procs:
            self.tasks.put(None)
        for proc in self.procs:
            proc.start()
        self.done = {}

    def result(self, index):
        """(the analysis, seconds) of DRYRUN_CELLS[index]; raises where a
        worker died without its results."""
        import queue
        while index not in self.done:
            try:
                i, res = self.results.get(timeout=5)
            except queue.Empty:
                dead = [p.exitcode for p in self.procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"fake-trace workers died: {dead}")
                continue
            self.done[i] = res
        res = self.done.pop(index)
        if isinstance(res, Exception):
            raise res
        return res

    def _signal(self, sig):
        import signal
        for proc in self.procs:
            if proc.is_alive():
                os.kill(proc.pid, getattr(signal, sig))

    @contextlib.contextmanager
    def paused(self):
        self._signal("SIGSTOP")
        try:
            yield
        finally:
            self._signal("SIGCONT")

    def close(self):
        """Join the workers (every result read), or end them."""
        self._signal("SIGCONT")
        for proc in self.procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.terminate()
                proc.join()


def _planted_no_lse(torch, fa_ops):
    """A planted analysis fault: flash's forward route that keeps neither
    the lse nor the f32 output for the backward (patches for
    ``mock.patch.multiple(fa_ops, **...)``)."""
    from repro_torch.kernels import analysis
    launch, launch_bwd = fa_ops._launch, fa_ops._launch_bwd

    def fwd(qt, kt, vt, *, causal, window, scale, with_lse=False):
        out = launch(qt, kt, vt, causal=causal, window=window, scale=scale)
        return (out, None, None) if with_lse else out

    def bwd(qt, kt, vt, o32, lse, dout, *, causal, window, scale):
        if not analysis.traced(qt):
            return launch_bwd(qt, kt, vt, o32, lse, dout, causal=causal,
                              window=window, scale=scale)
        b, h, s, hd = qt.shape
        grads = tuple(torch.empty_like(t) for t in (qt, kt, vt))
        torch.empty((b, h, s), dtype=torch.float32, device=qt.device)
        analysis.record("flash_attention_bwd", fa_ops.bwd_work(
            b, h, kt.shape[1], s, hd, causal, window, qt.element_size()),
            (qt, kt, vt, dout), grads)
        return grads
    return {"_launch": fwd, "_launch_bwd": bwd}


def dryrun_phase(torch, mods):
    """Slice 15: the analysis path (``launch.dryrun``: the step traced on
    the meta device, every kernel counted by its ``work()``) held against
    the same steps run on the card: predicted kernel calls equal the
    counters, predicted peak memory within DRYRUN_MEM_TOL of
    ``max_memory_allocated()``, no step faster than its bound, and finite
    logits or loss.  Since slice 17 the cells are the JAX package's
    assigned shapes (DRYRUN_CELLS).  A planted analysis that ignores remat
    must fail the launch gate, one that forgets flash's saved lse and o32
    the memory gate.  Each cell's analysis on fake CUDA tensors, which
    must equal the meta device's, comes from worker processes beside this
    one (``_FakeTraces``, since PR 29)."""
    import ctypes

    from repro_torch.kernels.mlstm import ops as ml_ops

    # the mlstm backward's scratch, as its analysis route sizes it
    for shape in ((2, 512, 4, 1024, 128), (1, 300, 4, 1024, 128),
                  (2, 1000, 4, 64, 64)):
        floats = ctypes.c_longlong()
        ml_ops.bwd_lib().ml_bwd_scratch_floats(*shape,
                                               ctypes.addressof(floats))
        assert floats.value == ml_ops.bwd_scratch_floats(*shape), shape

    card = _sh(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    rows = []
    fakes = _FakeTraces(DRYRUN_FAKE_WORKERS)
    try:
        for i, cell in enumerate(DRYRUN_CELLS):
            rows.append(_dryrun_row(torch, mods, i, fakes, card))
    finally:
        fakes.close()
    bad = [r for r in rows if not (r["launches_ok"] and r["mem_ok"]
                                   and r["bound_ok"] and r["finite"]
                                   and r["fake_cuda_equal"])]
    assert not bad, bad
    train_row = next(r for r in rows if r["cell"] == "train_4k-llama1b")
    flash_row = next(r for r in rows if r["cell"] == "flash")
    assert not train_row["fault_no_remat"]["launches_ok"], train_row
    assert not flash_row["fault_no_lse"]["mem_ok"], flash_row
    return rows


def _dryrun_row(torch, mods, index, fakes, card):
    """DRYRUN_CELLS[index]'s row of ``dryrun_phase``, printed."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import dryrun as dr
    from repro_torch.models import model as model_mod

    cell = DRYRUN_CELLS[index]
    name, arch, shape_name, b, why = cell
    t_cell = time.perf_counter()
    cfg, shape, fn, meta_args, make = dryrun_cell(torch, cell, "cuda")
    kind = shape.kind
    t0 = time.perf_counter()
    pred = dryrun_predict(torch, fn, meta_args, kind)
    trace_s = time.perf_counter() - t0
    faults = {}
    if name == "train_4k-llama1b":
        _, _, fn_nr, args_nr, _ = dryrun_cell(torch, cell, "cuda",
                                              remat=False)
        faults["no_remat"] = dryrun_predict(torch, fn_nr, args_nr, kind)
        del fn_nr, args_nr
    if name == "flash":
        with mock.patch.multiple(fa_ops,
                                 **_planted_no_lse(torch, fa_ops)):
            faults["no_lse"] = dryrun_predict(torch, fn, meta_args, kind)
    del meta_args
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t_make = time.perf_counter()
    args = make()
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t_make
    grad = kind in ("train", "flash")

    def step():
        with torch.set_grad_enabled(grad):
            return fn(*args)
    with fakes.paused():
        t_warm = time.perf_counter()
        step()                                  # warm
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t_warm
        steps = DRYRUN_FLASH_STEPS if kind == "flash" else \
            DRYRUN_STEPS if warm_s < DRYRUN_LONG_S else 1
        torch.cuda.reset_peak_memory_stats()
        for mod, attr in mods.values():
            setattr(mod, attr, 0)
        times, out = [], None
        for _ in range(steps):
            out = None              # the last step's outputs, not held
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = step()
            ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
    calls = {k: getattr(mod, attr) for k, (mod, attr) in mods.items()}
    peak = torch.cuda.max_memory_allocated() - base
    # the step's logits (prefill, decode), loss (train) or dq (flash)
    head = out[1]["loss"] if kind == "train" else out[0]
    finite = bool(torch.isfinite(head.float()).all())
    del args, out, head
    gc.collect()
    torch.cuda.empty_cache()

    fake, fake_trace_s = fakes.result(index)    # a worker's, meanwhile
    same_fake = all(fake[k] == pred[k] for k in (
        "kernels", "flops", "hbm_bytes", "peak_bytes"))

    def gates(p):
        want = {k: p["kernels"].get(k, {}).get("calls", 0) * steps
                for k in mods}
        mem_err = (p["peak_bytes"] - peak) / peak
        return want == calls, abs(mem_err) <= DRYRUN_MEM_TOL, mem_err
    launches_ok, mem_ok, mem_err = gates(pred)
    p50 = sorted(times)[len(times) // 2]
    bound_s = max(pred["flops"] / dr.PEAK_FLOPS,
                  pred["hbm_bytes"] / dr.HBM_BW)
    jax_b = SHAPES[shape_name].global_batch \
        if shape_name in SHAPES else None
    row = {"cell": name, "arch": arch, "shape": shape_name, "kind": kind,
           "B": b, "S": shape.seq_len, "layers": cfg.n_layers,
           "remat": cfg.remat,
           "grad_accum": (dr.GRAD_ACCUM[arch]
                          if shape_name == "train_4k" else 1),
           "window": (model_mod.decode_window(cfg, shape)
                      if kind == "decode" else 0),
           "reduced": ({"global_batch": [jax_b, b], "why": why}
                       if jax_b is not None and jax_b != b else None),
           "flops": pred["flops"], "kernel_flops": pred["kernel_flops"],
           "hbm_bytes": pred["hbm_bytes"],
           "terms_ms": {"compute": pred["flops"] / dr.PEAK_FLOPS * 1e3,
                        "memory": pred["hbm_bytes"] / dr.HBM_BW * 1e3,
                        "collective": 0.0},
           "bound_ms": bound_s * 1e3, "p50_ms": p50, "ms": times,
           "pred_calls": {k: v["calls"] for k, v in
                          pred["kernels"].items()},
           "pred_launches": {k: v["launches"] for k, v in
                             pred["kernels"].items()},
           "calls": calls, "steps": steps,
           "pred_peak_gb": pred["peak_bytes"] / 1e9,
           "meas_peak_gb": peak / 1e9, "mem_err": mem_err,
           "launches_ok": launches_ok, "mem_ok": mem_ok,
           "bound_ok": p50 * 1e-3 >= bound_s, "finite": finite,
           "trace_s": trace_s, "fake_trace_s": fake_trace_s,
           "make_s": make_s, "warm_s": warm_s,
           "cell_s": time.perf_counter() - t_cell,
           "fake_cuda_equal": same_fake,
           "fake_cuda": {k: fake[k] == pred[k] for k in (
               "kernels", "flops", "hbm_bytes", "peak_bytes")},
           "fake_cuda_hbm_bytes": fake["hbm_bytes"],
           "fake_cuda_flops": fake["flops"],
           "fake_cuda_kernels": fake["kernels"],
           "card": card}
    if kind != "flash":
        rl = dr.roofline({"flops": pred["flops"]},
                         {"hbm_bytes": pred["hbm_bytes"],
                          "collective_bytes": 0}, cfg, shape, 1)
        row.update(model_flops=rl["model_flops"],
                   mfu=rl["model_flops"] / (p50 * 1e-3 * dr.PEAK_FLOPS),
                   roofline_fraction=rl["roofline_fraction"],
                   bottleneck=rl["bottleneck"])
    for fault, p in faults.items():
        f_launch, f_mem, f_err = gates(p)
        row[f"fault_{fault}"] = {"launches_ok": f_launch, "mem_ok": f_mem,
                                 "mem_err": f_err}
    print(f"dryrun {json.dumps(row)}", flush=True)
    return row


# Slice 17: the long_500k shape's main path, a 500k-token context served
# by zamba2-2.7b through the window path at full width and depth: one
# ServeLoop(window=4096), batch 1, a prompt LONG_NEW tokens short of the
# shape's 524,288 (not a multiple of the window, so the ring's placement
# of the prompt's last rows decides the decode), LONG_NEW greedy tokens up
# to position 524,287.
LONG_ARCH = "zamba2-2.7b"
LONG_NEW = 64
LONG_SCAN_HEADS = 8            # the plain scan's heads at a time (memory)
# the f32 control: LONG_NEW greedy tokens after a prompt that ends 4032
# tokens past the ring's second wrap, as the 524k prompt ends past its
# 127th (3 x 4096 tokens in all: the prompt and the sequence must be
# multiples of the scan's 64-token chunk); its tolerance (normwise,
# logits): decode and forward sum in other orders over 54 layers in f32
# (1.1e-4 to 3.4e-4 at 960 to 65,536 tokens, window or not: PERF.md, PR
# 27)
LONG_CONTROL = 3 * 4096 - LONG_NEW
LONG_F32_TOL = 1e-3


def _scan_plain_by_heads(sr, x, dt, a, b, c, chunk):
    """``ref.ssd_chunked`` LONG_SCAN_HEADS heads at a time (the heads are
    independent): the plain version's f32 intermediates of all 80 heads at
    524k tokens would not fit the card."""
    ys, ss = [], []
    for h0 in range(0, x.shape[2], LONG_SCAN_HEADS):
        hs = slice(h0, h0 + LONG_SCAN_HEADS)
        y, st = sr.ssd_chunked(x[:, :, hs], dt[:, :, hs], a[hs], b, c, chunk)
        ys.append(y)
        ss.append(st)
    import torch
    return torch.cat(ys, dim=2), torch.cat(ss, dim=1)


def _close_by_rows(torch, got, want, atol, rtol, rows=16384):
    """(allclose, max abs error) of two (B, L, ...) tensors, compared
    ``rows`` positions at a time: the f32 temporaries of one comparison
    of a 524k-token tensor would not fit beside the inputs."""
    ok, err = bool(torch.isfinite(got.float()).all()), 0.0
    for i in range(0, got.shape[1], rows):
        g = got[:, i:i + rows].float()
        w = want[:, i:i + rows].float()
        ok = ok and torch.allclose(g, w, atol=atol, rtol=rtol)
        err = max(err, (g - w).abs().max().item())
    return ok, err


def check_long_kernels(torch, cfg, window, length):
    """The 500k serve's kernels against their plain versions at its
    length, with the existing gates, and each against a planted copy that
    must fail: mamba_scan at (1, length, 80, 64, 64) bf16 with slow gates
    (SCAN_GATES), so that the carry over length / 64 chunks decides the
    result (``carry_share`` above 0.1); flash, causal, at ``window``, over
    zamba2's heads (H 32 = KV 32, hd 80 through the padding wrapper),
    against ``ref.attention_ref_blocked`` (the (S, S) logits of
    ``attention_ref`` would not fit).  Times the kernels on their own
    inputs (flash on the padded (B, H, S, 128) layout, as check_kernel
    does), the plain versions once; no PyTorch call computes either
    function at this length (SDPA would need an (S, S) window mask)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.mamba_scan import ops as so
    from repro_torch.kernels.mamba_scan import ref as sr
    from repro_torch.models import ssm as ssm_mod

    gen = torch.Generator(device="cuda").manual_seed(27)
    rows = []
    # mamba_scan, slow gates
    _, h = ssm_mod.dims(cfg)
    p, n, chunk = cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk
    bf16 = torch.bfloat16
    x = (torch.randn((1, length, h, p), generator=gen, device="cuda")
         * 0.5).to(bf16)
    mean, std = SCAN_GATES["slow"]
    dt = torch.nn.functional.softplus(
        torch.randn((1, length, h), generator=gen, device="cuda") * std
        + mean)
    bb, cc = ((torch.randn((1, length, n), generator=gen, device="cuda")
               * 0.5).to(bf16) for _ in range(2))
    a = -torch.exp(torch.randn((h,), generator=gen, device="cuda") * 0.3)
    y, st = so.ssd(x, dt, a, bb, cc, chunk=chunk)
    t0 = time.perf_counter()
    yr, sr_ = _scan_plain_by_heads(sr, x, dt, a, bb, cc, chunk)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    tol = SCAN_TOL["bfloat16"]

    def scan_ok(y_, s_):
        return (_close_by_rows(torch, y_, yr, tol["y"][0], tol["y"][1])[0]
                and torch.allclose(s_, sr_, atol=tol["state"][0],
                                   rtol=tol["state"][1]))
    share = sr.carry_share(x, dt, a, bb, cc, chunk, sr_)
    fault = _build.load("mamba_scan_carry_fault",
                        _scan_carry_fault_source(), so._SIG)
    with mock.patch.object(so, "lib", lambda: fault):
        fault_ok = scan_ok(*so.ssd(x, dt, a, bb, cc, chunk=chunk))
    ms = _time_ms(lambda: so.ssd(x, dt, a, bb, cc, chunk=chunk), iters=3,
                  warmup=1)
    bound_ms, bound_by, flops, nbytes, f32_ms = _scan_bound(
        1, length, h, p, n, chunk, 2, "bfloat16")
    row = {"B": 1, "L": length, "H": h, "P": p, "N": n, "chunk": chunk,
           "dtype": "bfloat16", "gates": "slow", "inputs": "random",
           "carry_share": share,
           "max_abs_err": _close_by_rows(torch, y, yr, tol["y"][0],
                                         tol["y"][1])[1],
           "state_max_abs_err": (st - sr_).abs().max().item(), "tol": tol,
           "fault": "no state carried (ref.FWD_CARRY_FAULT)",
           "fault_ok": fault_ok,
           "ok": scan_ok(y, st) and share > 0.1 and not fault_ok,
           "ms": ms, "plain_ms": plain_ms, "plain_timed": "once, "
           f"{LONG_SCAN_HEADS} heads at a time", "library_ms": None,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_f32_cores_ms": f32_ms,
           "tflops": flops / (ms * 1e-3) / 1e12,
           "gbytes_per_s": nbytes / ms * 1e-6}
    print(f"kernel-check mamba_scan {json.dumps(row)}", flush=True)
    rows.append(row)
    del x, dt, bb, cc, y, st, yr, sr_
    torch.cuda.empty_cache()

    # flash, causal, windowed, zamba2's heads
    heads, hd = cfg.n_heads, cfg.hd()
    q, k, v = (torch.randn((1, length, heads, hd), generator=gen,
                           device="cuda").to(bf16) for _ in range(3))
    out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    t0 = time.perf_counter()
    ref = fa_ref.attention_ref_blocked(qt, kt, vt, window=window)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ref = ref.transpose(1, 2)
    tol = TOL["bfloat16"]

    def flash_ok(o):
        return _close_by_rows(torch, o, ref, tol, tol)[0]
    fault = _build.load("flash_attention_rescale_fault",
                        _flash_rescale_fault_source(), fa_ops._FWD_SIG)
    with mock.patch.object(fa_ops, "fwd_lib", lambda: fault):
        fault_ok = flash_ok(fa_ops.flash_attention(q, k, v, causal=True,
                                                   window=window))
    good, err = _close_by_rows(torch, out, ref, tol, tol)
    ok = good and not fault_ok
    del ref, out, qt, kt, vt
    pad = (-hd) % 128
    qp, kp, vp = (torch.nn.functional.pad(t.transpose(1, 2), (0, pad))
                  .contiguous() for t in (q, k, v))
    del q, k, v
    ms = _time_ms(lambda: fa_ops._launch(qp, kp, vp, causal=True,
                                         window=window, scale=hd ** -0.5),
                  iters=3, warmup=1)
    bound_ms, bound_by, flops = _bound(1, heads, heads, length, hd, True,
                                       window, "bfloat16", 2)
    row = {"B": 1, "S": length, "H": heads, "KV": heads, "hd": hd,
           "hd_padded": hd + pad, "causal": True, "window": window,
           "dtype": "bfloat16", "max_abs_err": err, "tol": tol,
           "fault": "no rescale (ref.FWD_RESCALE_FAULT)",
           "fault_ok": fault_ok, "ok": ok, "ms": ms, "plain_ms": plain_ms,
           "plain": "attention_ref_blocked, timed once", "library_ms": None,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "tflops": flops / (ms * 1e-3) / 1e12}
    print(f"kernel-check {json.dumps(row)}", flush=True)
    rows.append(row)
    del qp, kp, vp
    fa_ops.reset_launches()
    so.reset_launches()
    torch.cuda.empty_cache()
    return rows


def serve_vs_forward(torch, cfg, params, plen, new, window, mods):
    """One ``ServeLoop`` run at ``window`` of a seeded prompt of ``plen``
    tokens for ``new`` greedy tokens, its kernel launches counted (every
    count set to 0 before it, read after it), then the model's own
    windowed forward over the same plen + new tokens (the prompt and the
    served tokens), unembedded from the last prompt position on as
    ``make_ragged_prefill`` does (the (S, V) logits of a 524k-token
    sequence would take 67 GB).  Returns the row: the distance (normwise)
    of the last decode step's logits from the forward's at the last
    position, and how many served tokens are the forward's greedy token,
    or within TOL (of the largest logit) of its logit, a near tie that
    rounding may flip."""
    import numpy as np

    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import matmul_f32out
    from repro_torch.runtime.serve_loop import Request, ServeLoop

    prompt = np.random.default_rng(17).integers(
        0, cfg.vocab, plen).astype(np.int32)
    loop = ServeLoop(cfg, params, max_len=plen + new, window=window)
    prefill, serve, last = loop._prefill, loop._serve, {}

    def capture_prefill(*args):
        last["prefill"], states = prefill(*args)
        return last["prefill"], states

    def capture(*args):
        logits, states = serve(*args)
        last["logits"] = logits
        return logits, states
    loop._prefill, loop._serve = capture_prefill, capture
    req = Request(rid=0, prompt=prompt, max_new_tokens=new)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod, attr in mods.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    with torch.no_grad():
        loop.start([req])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        while loop.decode_step():
            pass
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k: getattr(mod, attr) for k, (mod, attr) in mods.items()}
    serve_peak = torch.cuda.max_memory_allocated()
    del loop

    seq = torch.as_tensor(np.concatenate(
        [prompt, np.asarray(req.out, np.int32)]), device="cuda")[None]
    torch.cuda.reset_peak_memory_stats()
    t3 = time.perf_counter()
    with torch.no_grad():
        hidden, _, _ = tf.forward(params, seq, cfg,
                                  {"window": window, "return_hidden": True})
        ref = matmul_f32out(hidden[:, plen - 1:], tf._head(params, cfg))[0]
        del hidden
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t3
    check_peak = torch.cuda.max_memory_allocated()
    for mod, attr in mods.values():
        setattr(mod, attr, 0)
    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()
    tol = TOL["bfloat16"]
    served = last["logits"][0, 0].float()
    out = torch.as_tensor(req.out, device="cuda")
    steps = ref[:-1]
    gap = steps.max(-1).values - steps.gather(-1, out[:, None].long())[:, 0]
    scale = steps.abs().max(-1).values
    exact = int((steps.argmax(-1) == out).sum())
    row = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "window": window, "prompt": plen, "new": new,
           "last_position": plen + new - 1,
           "prompt_mod_window": plen % window if window else None,
           "prefill_s": t1 - t0, "decode_s_per_token": (t2 - t1) / new,
           "tokens_per_s": new / (t2 - t1),
           "serve_peak_gb": serve_peak / 1e9, "launches": launches,
           "check_s": check_s, "check_peak_gb": check_peak / 1e9,
           "prefill_logits_rel": rel(last["prefill"][0, 0].float(), ref[0]),
           "last_logits_rel": rel(served, ref[-1]),
           "tol": tol, "tokens_equal": exact,
           "tokens_near_tie": int((gap <= tol * scale).sum()) - exact,
           "max_gap_rel": (gap / scale).max().item(),
           "finite": bool(torch.isfinite(served).all()
                          and torch.isfinite(ref).all()),
           "card": _sh(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"])}
    del ref, steps, seq, last, served
    gc.collect()
    torch.cuda.empty_cache()
    return row


def long_context_serve(torch, mods):
    """The long_500k main path: zamba2-2.7b served by ``ServeLoop`` with
    the shape's window at full width and depth, a seeded prompt of
    524,288 - LONG_NEW tokens and LONG_NEW greedy tokens, held against the
    model's windowed forward (``serve_vs_forward``; ``long-serve`` line:
    prefill seconds, decode seconds a token, peak memory, launches: each
    shared-attention use one flash launch and each Mamba layer one
    mamba_scan launch, none in decode).

    In bf16 at full depth a decode step and the forward are two roundings
    of the model (decode keeps the Mamba B and C in f32, as the JAX
    package's does; the prefill rounds them) that random weights carry
    apart over 54 layers: their logits lie 0.28-0.46 apart (normwise) at
    any length from 960 tokens up, window or not, while in f32 they agree
    within 3.4e-4 with every token equal (``long_context_probe.py``;
    PERF.md, PR 27).  So the path is held in f32 first
    (``long-serve-control``: the same weights and window over
    LONG_CONTROL tokens, the ring wrapped with the 524k prompt's residue,
    every served token the forward's and the last logits within
    LONG_F32_TOL); then at 524k in
    bf16 the prefill's last logits are held within TOL of the forward's
    (the same function through the same kernels), and the decode's last
    logits must lie nearer the forward's than unrelated logits (sqrt(2)
    apart at equal norms): under 1.  Returns the serve's launches by
    kernel."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer as tf
    from repro_torch.weights import tree_map

    cfg = get_config(LONG_ARCH)
    shape = SHAPES["long_500k"]
    window = model_mod.decode_window(cfg, shape)
    plen = shape.seq_len - LONG_NEW
    assert plen % window, "the prompt must not fill the ring evenly"
    assert LONG_CONTROL % window == plen % window
    rows = check_long_kernels(torch, cfg, window, shape.seq_len)
    assert all(r["ok"] for r in rows), rows

    gen = torch.Generator(device="cuda").manual_seed(17)
    with torch.no_grad():
        params = tf.init_params(gen, cfg, device="cuda")
    f32cfg = cfg.with_(dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    f32 = serve_vs_forward(torch, f32cfg, params32, LONG_CONTROL, LONG_NEW,
                           window, mods)
    del params32
    print(f"long-serve-control {json.dumps(f32)}", flush=True)
    assert f32["tokens_equal"] == LONG_NEW and max(
        f32["last_logits_rel"], f32["prefill_logits_rel"]) <= LONG_F32_TOL, \
        f32
    row = serve_vs_forward(torch, cfg, params, plen, LONG_NEW, window, mods)
    period = cfg.period()
    want = dict.fromkeys(mods, 0)
    want["flash_attention"] = cfg.n_periods() * period.count("shared_attn")
    want["mamba_scan"] = cfg.n_periods() * period.count("mamba")
    row["launches_want"] = want
    row["f32_tol"] = LONG_F32_TOL
    print(f"long-serve {json.dumps(row)}", flush=True)
    del params
    torch.cuda.empty_cache()
    assert row["finite"] and row["launches"] == want, row
    assert row["prefill_logits_rel"] <= row["tol"] \
        and row["last_logits_rel"] < 1.0, row
    return row["launches"]


def state_nbytes(cfg):
    """The bf16 train state's bytes: params, the f32 moments m and v, the
    int step."""
    from repro_torch.models.model import count_params
    return count_params(cfg) * (cfg.torch_dtype().itemsize + 8) + 4


def _clone_state(torch, state):
    from repro_torch.weights import tree_map
    return tree_map(lambda x: x if isinstance(x, int) else x.clone(), state)


def _gang_step(torch, cfg, ocfg, frac):
    """One step of the training phase's gang (4 ranks, 2 pods,
    compressed sync): the function the runtime runs each step."""
    from repro_torch.runtime.train_loop import make_dp_train_step
    return make_dp_train_step(cfg, ocfg, GANG["pods"],
                              GANG["ranks"] // GANG["pods"], "compressed",
                              frac)


def diffsync_check(torch, cfg):
    """The fused diff + merge over the full-width train state: fork = a
    seeded state, child = the fork after one gang step, and every leaf of
    the child merged into the fork (main = fork) by
    ``fused_diff_apply(use_kernel=None)``, once with op sum and once with
    overwrite.  Leaves of 2^20 elements or more must reach the kernel
    (counted), bit for bit equal to the plain version; the rest take the
    host path; the overwrite merge has the child's fingerprint.  Kernel
    and plain times are CUDA-event times of the one call per leaf."""
    from repro_torch.core import collectives as coll
    from repro_torch.core import diffsync as ds
    from repro_torch.core.snapshot import _fingerprint
    from repro_torch.data import pipeline as dp
    from repro_torch.kernels.diff_merge import ops as dm
    from repro_torch.kernels.diff_merge import ref as dr
    from repro_torch.models import model as model_mod
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.weights import tree_leaves, tree_leaves_with_path

    ocfg = AdamWConfig(lr=GANG["lr"], warmup_steps=1, total_steps=4)
    gen = torch.Generator(device="cuda").manual_seed(1)
    fork = model_mod.init_train_state(gen, cfg, ocfg, device="cuda")
    child = _clone_state(torch, fork)
    dcfg = dp.DataConfig(vocab=cfg.vocab, seq_len=GANG["seq_len"],
                         global_batch=GANG["global_batch"])
    batch = {k: v.cuda() for k, v in dp.make_batch(dcfg, 0).items()}
    resid = coll.init_residual_buffer(child["params"], GANG["pods"],
                                      GANG["ranks"] // GANG["pods"])
    child, _, _ = _gang_step(torch, cfg, ocfg, GANG["frac"])(child, batch,
                                                              resid)
    del batch, resid
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    child_fp = _fingerprint(tree_leaves(child))
    pairs = list(zip(tree_leaves_with_path(fork), tree_leaves(child)))
    res = {"leaves": len(pairs), "state_bytes": ds.tree_nbytes(fork),
           "child_fingerprint": child_fp}
    # one cached segment the merged leaves are carved from, so that no
    # timed call pays a cudaMalloc (once the dryrun and long-context
    # phases had emptied the cache, the first pass took 129 ms and the
    # second 19)
    torch.empty(res["state_bytes"], dtype=torch.uint8, device="cuda")
    dm.reset_launches()
    for op in ("sum", "overwrite"):
        per = {"kernel_leaves": 0, "host_leaves": [], "kernel_ms": 0.0,
               "plain_ms": 0.0, "host_ms": 0.0, "bytes": 0,
               "bit_exact": True}

        def merged_leaves():
            for (path, f), c in pairs:
                before = dm.launches
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                merged, dirty = ds.fused_diff_apply(f, f, c, op=op)
                end.record()
                torch.cuda.synchronize()
                n = ds.as_tensor(f).numel()
                if dm.launches == before:
                    per["host_leaves"].append(path)
                    per["host_ms"] += start.elapsed_time(end)
                else:
                    assert n >= ds.KERNEL_MIN_ELEMS, path
                    per["kernel_leaves"] += 1
                    per["kernel_ms"] += start.elapsed_time(end)
                    per["bytes"] += _dm_bytes(n, f.element_size())
                    start.record()
                    rm, rd = dr.diff_merge_leaf_ref(f, f, c, op=op)
                    end.record()
                    torch.cuda.synchronize()
                    per["plain_ms"] += start.elapsed_time(end)
                    per["bit_exact"] &= _dm_same(torch, merged, rm) and \
                        bool(torch.equal(dirty, rd))
                    del rm, rd
                yield merged
                del merged, dirty

        if op == "overwrite":
            per["fingerprint"] = _fingerprint(merged_leaves())
            per["fingerprint_is_childs"] = per["fingerprint"] == child_fp
        else:
            for _ in merged_leaves():
                pass
        per["bound_ms"] = per["bytes"] / HBM_BYTES_PER_S * 1e3
        per["gbytes_per_s"] = per["bytes"] / per["kernel_ms"] * 1e-6
        res[op] = per
    res["launches"] = dm.launches
    big = sum(ds.as_tensor(f).numel() >= ds.KERNEL_MIN_ELEMS
              for (_, f), _ in pairs)
    print(f"diffsync-check {json.dumps(res)}", flush=True)
    del fork, child, pairs
    torch.cuda.empty_cache()
    assert res["launches"] == 2 * big, (res["launches"], big)
    for op in ("sum", "overwrite"):
        assert res[op]["kernel_leaves"] == big and res[op]["bit_exact"], res
        assert all("norm" in p or "step" in p or "ln" in p
                   for p in res[op]["host_leaves"]), res
    assert res["overwrite"]["fingerprint_is_childs"], res
    return res


def _disk_check(need_bytes):
    os.makedirs(CKPT_ROOT, exist_ok=True)
    usage = shutil.disk_usage(CKPT_ROOT)
    row = {"dir": CKPT_ROOT, "free_gb": usage.free / 1e9,
           "need_gb": need_bytes / 1e9}
    print(f"ckpt-disk {json.dumps(row)}", flush=True)
    if usage.free < need_bytes:
        raise RuntimeError(f"{CKPT_ROOT} has {usage.free / 1e9:.1f} GB free; "
                           f"the ckpt phase writes {need_bytes / 1e9:.1f} GB")


def ckpt_check(torch, cfg, state_bytes):
    """Checkpoints, failure recovery, a delta chain and a delta migration
    of the full-width train state.  The gang runs 4 ranks in 2 pods with
    compressed sync at frac 1.0: recovery resets the error-feedback
    residual as the JAX runtime does, and at frac 1.0 the residual is
    zero, so the recovered run must repeat the lost steps' losses (at
    frac 0.05 it could not; tests/test_torch_train_loop.py pins that)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import migration as mig
    from repro_torch.core import snapshot as snap_mod
    from repro_torch.core import telemetry
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import (FaabricTrainRuntime,
                                                RuntimeConfig)
    from repro_torch.weights import tree_leaves

    steps = 4
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=GANG["seq_len"],
                      global_batch=GANG["global_batch"])
    ocfg = AdamWConfig(lr=GANG["lr"], warmup_steps=1, total_steps=steps)
    _disk_check(3 * state_bytes)       # run b keeps three full checkpoints
    def gang(name, failures, every):
        rt = RuntimeConfig(total_steps=steps, sync_mode="compressed",
                           compress_frac=1.0, pods=GANG["pods"],
                           checkpoint_every=every,
                           ckpt_dir=os.path.join(CKPT_ROOT, name),
                           inject_failures=failures)
        runtime = FaabricTrainRuntime(cfg, ocfg, dcfg, rt,
                                      ranks=GANG["ranks"], device="cuda")
        tel = telemetry.enable()
        t0 = time.perf_counter()
        try:
            state, out = runtime.run(seed=0)
        finally:
            telemetry.disable()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans = [{"name": sp["name"], "s": sp["t1"] - sp["t0"],
                  **{k: sp["attrs"][k] for k in ("step", "kind")}}
                 for sp in tel.spans if sp["name"].startswith("ckpt.")]
        return state, out, runtime.ckpt.stats, spans, wall

    # the uninterrupted run saves only the state before step 0 (as every
    # run does): its losses and final state are what the recovered run
    # must repeat, and its periodic saves would add nothing to check.
    # Its final state stays on the card to be compared bit for bit with
    # the recovered run's (two host fingerprints took ~20 s more).
    state_a, base, stats_a, spans_a, wall_a = gang("a", {}, 0)
    full_bytes = stats_a[0]["full_bytes"]
    shutil.rmtree(os.path.join(CKPT_ROOT, "a"))
    state, failed, stats_b, spans_b, wall_b = gang("b", {3: "chip_smoke"}, 2)
    states_equal = all(
        bool(torch.equal(x, y)) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(tree_leaves(state_a), tree_leaves(state)))
    del state_a
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(CKPT_ROOT, "b"))
    diff = max(abs(x - y) for x, y in zip(base["losses"], failed["losses"]))
    res = {"recoveries": failed["recoveries"], "losses": base["losses"],
           "losses_recovered": failed["losses"], "max_abs_diff": diff,
           "atol": 1e-6, "states_equal": states_equal,
           "full_bytes": full_bytes, "wall_s": [wall_a, wall_b],
           "saves": [{k: s[k] for k in ("step", "kind", "bytes",
                                        "device_to_host_s")}
                     for s in stats_b],
           "spans": {run: [{**sp, "gbytes_per_s": full_bytes / sp["s"] * 1e-9}
                           for sp in spans]
                     for run, spans in (("a", spans_a), ("b", spans_b))}}
    print(f"ckpt {json.dumps(res)}", flush=True)
    assert res["recoveries"] == 1, res
    assert len(failed["losses"]) == steps and diff <= 1e-6, res
    assert states_equal, "the recovered run's final state differs"

    # a (base, delta) chain of 2 saves (short, for the script's time
    # limit): rows of the embedding and the step move between saves, as a
    # sparse update would
    mgr = CheckpointManager(os.path.join(CKPT_ROOT, "chain"), job_id="chain",
                            delta_chain=True)
    emb = state["params"]["embed"]
    t0 = time.perf_counter()
    for s in range(2):
        if s:
            emb[1000 * s:1000 * s + 16].add_(1.0)
            state["opt"]["step"] += 1
        mgr.save(s, state, blocking=s == 1)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, step = mgr.restore(1, device="cuda")
    restore_s = time.perf_counter() - t0
    exact = step == 1 and all(
        a == b if isinstance(a, int) else bool(torch.equal(a, b))
        for a, b in zip(tree_leaves(restored), tree_leaves(state)))
    del restored
    chain = {"kinds": [s["kind"] for s in mgr.stats],
             "bytes": [s["bytes"] for s in mgr.stats],
             "full_bytes": mgr.stats[0]["full_bytes"],
             "save_s": save_s, "restore_s": restore_s, "bit_exact": exact}
    shutil.rmtree(os.path.join(CKPT_ROOT, "chain"))

    # a delta migration: the target holds the step-4 snapshot already
    prior = snap_mod.take("job0", 4, state)
    emb[5000:5008].mul_(2.0)
    state["opt"]["step"] += 1
    moved, mst = mig.migrate_via_snapshot("job0", 5, state, "cuda",
                                          prior=prior)
    del prior
    verified = mig.verify_migration(state, moved)
    migration = {k: mst[k] for k in ("full_bytes", "moved_bytes", "delta",
                                      "seconds")}
    migration["verified"] = verified
    res2 = {"chain": chain, "migration": migration}
    print(f"ckpt-delta {json.dumps(res2)}", flush=True)
    del state, moved
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    assert chain["kinds"] == ["full", "delta"] and exact, res2
    assert max(chain["bytes"][1:]) * 100 < chain["full_bytes"], res2
    assert verified and mst["moved_bytes"] * 100 < mst["full_bytes"], res2
    return res, res2


# ---------------------------------------------------------------------------
# Slice 9: the shared Fabric running train and serve gangs
# ---------------------------------------------------------------------------
# The trace (virtual seconds): 8 virtual devices, 2 a host (hosts 0-3),
# checkpoints every 10.  At t=0 train-c (4 chips, compressed sync over 2
# pods), train-h (2 chips, hierarchical) and serve-0 start; serve-hi
# (priority 5) arrives at t=2 and preempts train-c, which resumes at t=7
# when it finishes; host 0 hard-fails at t=4 and rolls train-h back to
# its last snapshot (the start baseline), and it resumes on host 3 at
# t=10; train-c takes a delta checkpoint at t=17; a lease reclaim of host
# 3 at t=18 evacuates train-h (a live migration) onto the chips train-c
# freed, and it takes a delta checkpoint at t=20.  Each train gang takes
# 3 steps of world x 512 tokens; each serve gang serves 2 requests
# (prompts 128 and 127) of 3 tokens.
FABRIC = {"pool": 8, "chips_per_host": 2, "ckpt_interval": 10.0,
          "seq_len": 512, "train_steps": 3, "serve_tokens": 3,
          "prompt_len": 128, "frac": 0.05, "lr": 1e-3,
          "jobs": [("train-c", "mpi-compute", 4, 40.0, 0.0, 0, "train"),
                   ("train-h", "mpi-compute", 2, 30.0, 0.0, 0, "train"),
                   ("serve-0", "omp", 2, 16.0, 0.0, 1, "serve"),
                   ("serve-hi", "omp", 2, 8.0, 2.0, 5, "serve")],
          "fail": (4.0, [0]), "reclaim": (18.0, [3], 3.0)}


def _fabric_workload(torch, cfg, job):
    """The trace's workload of ``job``: train-c compresses across 2 pods,
    train-h syncs hierarchically; serve gangs seed their weights with
    their priority + 1 (the JAX factory's seeds)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.gang_workloads import (ServeWorkload,
                                                    TrainWorkload)
    if job.workload == "serve":
        return ServeWorkload(cfg, prompt_len=FABRIC["prompt_len"],
                             new_tokens=FABRIC["serve_tokens"], batch=2,
                             max_len=FABRIC["prompt_len"]
                             + FABRIC["serve_tokens"] + 1,
                             seed=job.priority + 1)
    steps = FABRIC["train_steps"]
    compressed = job.job_id == "train-c"
    return TrainWorkload(
        cfg, AdamWConfig(lr=FABRIC["lr"], warmup_steps=1,
                         total_steps=steps),
        DataConfig(vocab=cfg.vocab, seq_len=FABRIC["seq_len"],
                   global_batch=job.parallelism),
        total_steps=steps,
        sync_mode="compressed" if compressed else "hierarchical",
        compress_frac=FABRIC["frac"], pods=2 if compressed else 1)


def _span_rows(spans, prefix):
    return [{"name": sp["name"], "job": sp["attrs"].get("job"),
             "s": sp["t1"] - sp["t0"],
             **{k: sp["attrs"][k] for k in ("kind", "bytes", "step")
                if k in sp["attrs"]}}
            for sp in spans if sp["name"].startswith(prefix)]


def fabric_phase(torch, cfg, mods):
    """The port's shared Fabric (slice 9) at the full width and depth of
    llama3.2-1b: ``Fabric.run_trace`` over FABRIC's trace, against
    ``predict_trace`` of the same trace.  Kernel counts are set to 0
    just before the trace and read just after; the trace runs under
    telemetry (gang, checkpoint and placement spans) and the profiler
    (device busy time).  Asserts: the live completion order is the
    predicted one; every resume restored its snapshot's fingerprint; the
    rolled-back gang's losses are within 1e-6 of an uninterrupted run of
    the same gang.  Then the grow-with-drain step (``grow_drain``).
    Returns the kernel launches of the trace and the step together."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch.core import telemetry
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.fleet import FleetEvent
    from repro_torch.core.simulator import Job

    jobs = [Job(i, k, n, w, arrival=a, priority=p, workload=wk)
            for i, k, n, w, a, p, wk in FABRIC["jobs"]]
    by_id = {j.job_id: j for j in jobs}
    (t_fail, dead), (t_rec, drained, drain_s) = FABRIC["fail"], \
        FABRIC["reclaim"]
    events = [FleetEvent(t_fail, "fail", hosts=dead),
              FleetEvent(t_rec, "reclaim", hosts=drained, drain_s=drain_s)]

    # the uninterrupted reference of the gang the failure rolls back
    ref_fab = Fabric(n_virtual=2, chips_per_host=2, device="cuda")
    ref_h = ref_fab.allocate("train-h", 2)
    ref = _fabric_workload(torch, cfg, by_id["train-h"])
    ref.bind(ref_h)
    ref.init_state(ref_h)
    for _ in range(FABRIC["train_steps"]):
        ref.run_step(ref_h)
    ref_losses = list(ref.losses)
    ref_h.release()
    del ref, ref_h, ref_fab
    torch.cuda.empty_cache()

    fab = Fabric(n_virtual=FABRIC["pool"],
                 chips_per_host=FABRIC["chips_per_host"], device="cuda")
    kw = dict(preempt=True, fleet_events=events,
              checkpoint_interval=FABRIC["ckpt_interval"])
    pred = fab.predict_trace(jobs, **kw)
    made, handles = {}, {}

    def factory(job):
        wl = made[job.job_id] = _fabric_workload(torch, cfg, job)
        bind = wl.bind

        def tracked(handle):
            handles[job.job_id] = handle
            bind(handle)
        wl.bind = tracked
        return wl

    for mod, attr in mods.values():
        setattr(mod, attr, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tel = telemetry.enable()
    try:
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            ex = fab.run_trace(jobs, factory, **kw)
            torch.cuda.synchronize()
    finally:
        telemetry.disable()
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in mods.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    busy_us, by_kind = 0.0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy_us += us
            kind = next((kind for kind, keys in KERNEL_KINDS
                         if any(key in e.name for key in keys)), "other")
            by_kind[kind] = by_kind.get(kind, 0.0) + us * 1e-6
    res = ex.result
    print("fabric-devices " + json.dumps(
        {"pool": len(fab.devices), "kind": fab.devices[0].device_kind,
         "cuda_device_count": torch.cuda.device_count(),
         "hosts": fab.engine.hosts}), flush=True)
    live_ms = res.makespans(jobs)
    pred_ms = pred.makespans(jobs)
    print("fabric-makespans " + json.dumps(
        {"jobs": {j.job_id: {"live_s": live_ms.get(j.job_id),
                             "predicted_s": pred_ms.get(j.job_id)}
                  for j in jobs},
         "live_order": res.finish_order,
         "predicted_order": pred.finish_order,
         "preemptions": res.preemptions, "recoveries": res.recoveries,
         "evacuations": res.evacuations, "wall_s": ex.wall_s}),
        flush=True)
    diff = telemetry.diff_traces(pred, res)
    print("fabric-diff " + json.dumps(
        {k: diff[k] for k in ("n_predicted", "n_live", "aligned",
                              "divergences", "first_divergence")}),
        flush=True)
    stalls = _span_rows(tel.spans, "gang.")
    stalls = [r for r in stalls if r["name"] in (
        "gang.preempt", "gang.checkpoint", "gang.resume", "gang.fail")]
    print("fabric-stalls " + json.dumps(
        {"spans": stalls, "saves": _span_rows(tel.spans, "ckpt.save")}),
        flush=True)
    moves = {j: r.get("moves", []) for j, r in ex.live.items()
             if r.get("moves")}
    print("fabric-moves " + json.dumps(moves), flush=True)
    lat = {}
    for sp in tel.spans:
        if sp["name"].startswith("placement."):
            lat.setdefault(sp["name"], []).append(sp["t1"] - sp["t0"])
    print("fabric-placement " + json.dumps(
        {k: {"count": len(v), "p50_s": sorted(v)[len(v) // 2],
             "max_s": max(v)} for k, v in sorted(lat.items())}),
        flush=True)
    print("fabric-device " + json.dumps(
        {"peak_gb": peak_gb, "device_busy_s": busy_us * 1e-6,
         "by_kind_s": by_kind, "wall_s": ex.wall_s,
         "idle_share": 1.0 - busy_us * 1e-6 / ex.wall_s}), flush=True)
    print("fabric-launches " + json.dumps(launches), flush=True)

    # the rolled-back gang against its uninterrupted reference
    victim = next(a.payload["job"] for a in res.actions
                  if a.kind == "recover")
    replay = [(s, loss, abs(loss - ref_losses[s]))
              for s, loss in made[victim].loss_log]
    # each resume's restored state against the snapshot it resumed
    verified = {}
    for jid, h in handles.items():
        snap_fp, pairs = None, []
        for e in h.epoch_log:
            if e["kind"] in ("preempt", "fail"):
                snap_fp = e["fingerprint"]
            elif e["kind"] == "resume":
                pairs.append((snap_fp, e["restored_fingerprint"]))
        verified[jid] = pairs
    out = {"victim": victim, "reference_losses": ref_losses,
           "replayed": replay, "atol": 1e-6,
           "resumes": {j: len(v) for j, v in verified.items()}}
    print("fabric-check " + json.dumps(out), flush=True)
    del made, handles, ex, fab
    torch.cuda.empty_cache()
    assert res.finish_order == pred.finish_order, (res.finish_order,
                                                   pred.finish_order)
    assert res.preemptions >= 1 and res.recoveries >= 1 \
        and res.evacuations >= 1, out
    assert all(a == b for v in verified.values() for a, b in v), verified
    assert sum(len(v) for v in verified.values()) >= 2, verified
    assert sum(1 for s, _, _ in replay if s == 0) >= 2, replay
    assert all(d <= 1e-6 for _, _, d in replay), replay
    for name in ("flash_attention", "flash_attention_bwd",
                 "collective_codec", "diff_merge"):
        assert launches[name] > 0, launches
    grown = grow_drain(torch, cfg, mods)
    return {name: launches[name] + grown[name] for name in launches}


# The grow-with-drain step: a train gang of 6 virtual chips and a serve gang
# of 2 on the phase's 8; the serve gang grows to 4, the train gang drains
# to 3 (its floor is 2).
GROW = {"train": 6, "serve": 2, "floor": 2, "seq_len": 512,
        "global_batch": 6, "over": 8}


def grow_drain(torch, cfg, mods):
    """``Fabric.grow_with_drain`` at the full width of ``cfg`` (the
    serve side of slice 10; tests/test_serving.py:254 at full width): a
    ``ServeAutoscaler`` under a breach on the full pool emits "need" for
    world 4, the serve gang grows to it by draining the train gang (the
    donor) from 6 chips to 3, and both gangs step again.  Checks that the
    donor's parameters and optimizer state right after the drain equal
    those right before it bit for bit (a drain keeps every step), and
    that a grow to 8 raises RuntimeError.  Kernel counts are set to 0
    just before and read just after; prints ``fabric-grow-drain``.
    Returns the step's launches."""
    from repro_torch.core.elastic import ElasticPolicy
    from repro_torch.core.fabric import Fabric
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.admission import ServeAutoscaler, ServeSLO
    from repro_torch.runtime.gang_workloads import (ServeWorkload,
                                                    TrainWorkload)
    from repro_torch.weights import tree_leaves

    for mod, attr in mods.values():
        setattr(mod, attr, 0)
    fab = Fabric(n_virtual=FABRIC["pool"],
                 chips_per_host=FABRIC["chips_per_host"], device="cuda")
    t = fab.allocate("train0", GROW["train"], priority=0)
    s = fab.allocate("serve0", GROW["serve"], priority=5)
    twl = TrainWorkload(
        cfg, AdamWConfig(lr=FABRIC["lr"], warmup_steps=1, total_steps=4),
        DataConfig(vocab=cfg.vocab, seq_len=GROW["seq_len"],
                   global_batch=GROW["global_batch"]), total_steps=4)
    twl.bind(t)
    twl.init_state(t)
    twl.run_step(t)
    swl = ServeWorkload(cfg, prompt_len=FABRIC["prompt_len"],
                        new_tokens=FABRIC["serve_tokens"], batch=2,
                        max_len=FABRIC["prompt_len"]
                        + FABRIC["serve_tokens"] + 1, seed=1)
    swl.bind(s)
    swl.init_state(s)
    swl.run_step(s)
    scaler = ServeAutoscaler(ElasticPolicy(min_world=1, max_world=8),
                             fab.engine, slo=ServeSLO(target_p99_s=0.5),
                             base_world=GROW["serve"])
    acts = scaler.decide(0.0, queue_depth=0, p99=1.0,
                         gang_worlds={"serve0": s.n})
    assert [(a.kind, a.world) for a in acts] == [("need", 4)], acts
    before = [x.clone() if isinstance(x, torch.Tensor) else x
              for x in tree_leaves(twl.state)]
    worlds = {"serve": [s.n], "train": [t.n]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, donors = fab.grow_with_drain(
        s, swl.state, acts[0].world,
        donors=[(t, twl.state, GROW["floor"])])
    torch.cuda.synchronize()
    grow_s = time.perf_counter() - t0
    worlds["serve"].append(s.n)
    worlds["train"].append(t.n)
    after = tree_leaves(donors["train0"])
    same = len(after) == len(before) and all(
        (a.dtype == b.dtype and torch.equal(a, b))
        if isinstance(a, torch.Tensor) else a == b
        for a, b in zip(before, after))
    del before, after
    twl.state = donors["train0"]
    twl.bind(t)
    swl.state = state
    swl.bind(s)
    twl.run_step(t)
    swl.run_step(s)
    over = None
    try:
        fab.grow_with_drain(s, swl.state, GROW["over"],
                            donors=[(t, twl.state, GROW["floor"])])
    except RuntimeError as e:
        over = str(e)
    torch.cuda.synchronize()
    launches = {name: getattr(mod, attr) for name, (mod, attr)
                in mods.items()}
    moves = {h.job_id: [{k: e[k] for k in ("kind", "to", "seconds",
                                            "bytes") if k in e}
                        for e in h.epoch_log if e["kind"] == "rescale"]
             for h in (s, t)}
    res = {"worlds": worlds, "action": [acts[0].kind, acts[0].world],
           "grow_s": grow_s, "reshards": moves,
           "donor_state_bit_exact": same, "losses": twl.losses,
           "serve_tokens": [list(r.out) for r in swl.requests],
           "over_grow_raised": over, "launches": launches}
    print("fabric-grow-drain " + json.dumps(res), flush=True)
    s.release()
    t.release()
    del twl, swl, state, donors, fab
    torch.cuda.empty_cache()
    assert worlds == {"serve": [2, 4], "train": [6, 3]}, worlds
    assert same, "the drain changed the donor's state"
    assert over is not None, "a grow past the pool did not raise"
    assert len(res["losses"]) == 2 and all(
        math.isfinite(x) for x in res["losses"]), res["losses"]
    assert launches["flash_attention"] > 0 \
        and launches["flash_attention_bwd"] > 0, launches
    return launches


# Slice 16: the risk-aware spot wave, examples/spot_fleet_torch.py's act 2
# (``risk_aware_wave``: 6 leased virtual chips in 3 hosts of 2 and a spare
# host of 2, CostModel(risk_tau_s=4.0); a 4-chip train gang and a 2-chip
# serve gang; host 0 hard-fails at 6.0 s, the spare host joins at 10.0 s;
# shrink_recovery on, checkpoints every 4.0 s) with gangs at the full
# width of llama3.2-1b: the gangs' batch, steps and learning rate.
SPOT = {"seq_len": 512, "global_batch": 8, "train_steps": 4,
        "serve_tokens": 4, "lr": 1e-3}


def fabric_spot(torch, cfg, mods):
    """spot_fleet's act 2 (``risk_aware_wave``) at the width of ``cfg``:
    ``Fabric.run_trace`` with ``shrink_recovery=True`` against
    ``predict_trace`` of the same trace.  The wide train gang loses a
    host, sheds its chips and reshards from a surviving replica
    (``elastic.reshard_gang``), then regrows onto the joined spare host.
    Each reshard's state is compared with the replica it came from, bit
    for bit, on the card.  Kernel counts are set to 0 just before the
    trace and read just after; the trace runs under the CUDA profiler
    (idle share).  Asserts: the live Action log is the predicted one; at
    least one shrink and one regrow, no recovery, no lost work; every
    reshard bit-exact; the gangs launched the flash kernels.  Prints
    ``fabric-spot``; returns the trace's launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch.core import elastic as elastic_mod
    from repro_torch.core.devices import virtual_devices
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.gang_workloads import workload_factory
    from repro_torch.weights import tree_leaves

    sys.path.insert(0, os.path.join(REPO, "examples"))
    from spot_fleet_torch import risk_aware_wave

    steps = SPOT["train_steps"]
    factory = workload_factory(
        cfg, AdamWConfig(lr=SPOT["lr"], warmup_steps=1, total_steps=steps),
        DataConfig(vocab=cfg.vocab, seq_len=SPOT["seq_len"],
                   global_batch=SPOT["global_batch"]),
        train_steps=steps, serve_tokens=SPOT["serve_tokens"])
    reshards = []
    reshard = elastic_mod.reshard_gang

    def checked(state, new_devices):
        new_state, mesh, stats = reshard(state, new_devices)
        pairs = list(zip(tree_leaves(state), tree_leaves(new_state)))
        same = len(pairs) == len(tree_leaves(state)) and all(
            (a.dtype == b.dtype and torch.equal(a, b))
            if isinstance(a, torch.Tensor) else a == b for a, b in pairs)
        reshards.append({"to_chips": len(new_devices), "bit_exact": same,
                         **stats})
        return new_state, mesh, stats

    for mod, attr in mods.values():
        setattr(mod, attr, 0)
    torch.cuda.synchronize()
    with mock.patch.object(elastic_mod, "reshard_gang", checked), \
            tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        ex, pred = risk_aware_wave(virtual_devices(8, "cuda"), factory)
        torch.cuda.synchronize()
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in mods.items()}
    busy_s = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA) * 1e-6
    res = ex.result
    train = ex.live["train-wide"]
    out = {"card": _sh(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"]),
           "layers": cfg.n_layers,
           "actions_equal": res.actions == pred.actions,
           "n_actions": len(res.actions),
           "churn": [(a.kind, a.payload.get("hosts")) for a in res.actions
                     if a.kind in ("host-fail", "shrink", "join", "regrow",
                                   "recover")],
           "order": res.finish_order, "predicted_order": pred.finish_order,
           "makespan_s": res.makespan, "predicted_makespan_s": pred.makespan,
           "shrinks": res.shrinks, "regrows": res.regrows,
           "recoveries": res.recoveries, "lost_work_s": res.lost_work_s,
           "moves": train.get("moves", []), "reshards": reshards,
           "checkpoints": {j: {k: rec.get(k, 0) for k in (
               "checkpoints", "delta_checkpoints", "ckpt_bytes",
               "ckpt_full_bytes")} for j, rec in ex.live.items()},
           "train_loss": train.get("final_metrics", {}).get("loss"),
           "wall_s": ex.wall_s, "device_busy_s": busy_s,
           "idle_share": 1.0 - busy_s / ex.wall_s, "launches": launches}
    print("fabric-spot " + json.dumps(out), flush=True)
    del ex, factory
    torch.cuda.empty_cache()
    assert out["actions_equal"], "the live Action log is not the predicted"
    assert res.shrinks >= 1 and res.regrows >= 1, out
    assert res.recoveries == 0 and res.lost_work_s == 0.0, out
    assert reshards and all(r["bit_exact"] for r in reshards), reshards
    assert launches["flash_attention"] > 0 \
        and launches["flash_attention_bwd"] > 0, launches
    return launches


# Slice 16: the twins of the JAX package's examples (examples/*_torch.py)
# on the card: (module, its arguments beside --device cuda, the
# control-plane outcomes the JAX example prints (makespans and lost work
# as it rounds them, to 0.1 s; the state in MiB to 0.1), the kernels each
# must launch).
EXAMPLES = [
    ("fault_tolerant_elastic_torch",
     ["--ckpt-dir", os.path.join(CKPT_ROOT, "examples")],
     {"devices": 8, "recoveries": 1, "rescales": 1},
     ("moe_gmm", "moe_gmm_bwd", "flash_attention", "flash_attention_bwd")),
    ("multi_tenant_fabric_torch", [],
     {"chips": 8, "hosts": 4, "evict": ["train0"], "checkpoint_step": 3},
     ("flash_attention", "flash_attention_bwd")),
    ("spot_fleet_torch", [],
     {"churn": [["drain", [2]], ["evacuate", None], ["host-fail", [1]],
                ["recover", None], ["join", [3]], ["retire", [2]]],
      "order": ["serve-0", "train-0"], "makespan": 113.0,
      "lost_work_s": 4.0, "shrinks": 1, "regrows": 1,
      "order2": ["train-wide", "serve-1"], "makespan2": 85.5},
     ("flash_attention", "flash_attention_bwd")),
    ("serve_longcontext_ssm_torch", [],
     {"state_mib": 0.1, "generated": 48, "bit_exact": True}, ())]


def example_outcomes(out, want):
    """The entries of a twin's returned outcomes that ``want`` names, as
    the JAX example prints them (floats to 0.1, tuples as lists)."""
    got = {}
    for key in want:
        val = out[key]
        if isinstance(val, float):
            val = round(val, 1)
        got[key] = json.loads(json.dumps(val))
    return got


def examples_phase(torch, mods):
    """Slice 16: each twin of EXAMPLES runs its ``main`` with ``--device
    cuda``: its own assertions hold, its control-plane outcomes equal the
    JAX example's, and it launches its kernels (counts set to 0 just
    before each and read just after; the xLSTM decode runs no kernel,
    its counts are printed as they are).  Prints ``examples`` rows;
    returns the launches."""
    import importlib

    sys.path.insert(0, os.path.join(REPO, "examples"))
    total = dict.fromkeys(mods, 0)
    for name, args, want, kernels in EXAMPLES:
        mod = importlib.import_module(name)
        for m, attr in mods.values():
            setattr(m, attr, 0)
        t0 = time.perf_counter()
        out = mod.main(["--device", "cuda"] + args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: getattr(m, attr) for k, (m, attr) in mods.items()}
        got = example_outcomes(out, want)
        print("examples " + json.dumps(
            {"example": name, "outcomes": got, "expected": want,
             "secs": secs, "launches": launches}), flush=True)
        shutil.rmtree(os.path.join(CKPT_ROOT, "examples"),
                      ignore_errors=True)
        assert got == json.loads(json.dumps(want)), (name, got, want)
        assert all(launches[k] > 0 for k in kernels), (name, launches)
        for k in total:
            total[k] += launches[k]
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# Slice 4: the MoE (granite-moe-1b-a400m) and hybrid (zamba2-2.7b) families
# ---------------------------------------------------------------------------
# Kernel against plain: f32 sums in another order (moe_gmm over d and ff;
# mamba_scan over N and the chunk, whose tolerances are the JAX kernel
# tests' own); bf16 adds one rounding of the output.  moe_gmm's absolute
# tolerance scales with the output's largest magnitude (|y| reaches ~500
# with the model's init): an f32 sum's error follows the size of its
# terms, not of its result.
GMM_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
SCAN_TOL = {"bfloat16": {"y": (2e-2, 2e-2), "state": (5e-5, 1e-3)},
            "float32": {"y": (5e-4, 1e-3), "state": (5e-5, 1e-3)}}


def _gmm_bound(e, m, d, ff, act, dtype_name, esize):
    """Least time of the expert FFN on this input: the larger of its bytes
    (x and the weights read once, y written once) over HBM bandwidth and
    its operations over the peak of the inputs' type; also the operations
    over the f32 CUDA-core peak (moe_gmm/ops.py ``work``)."""
    from repro_torch.kernels.moe_gmm import ops
    flops, nbytes = ops.work(e, m, d, ff, act, esize)
    return (*_roof(flops, nbytes, dtype_name), flops, nbytes,
            _roof(flops, nbytes, "float32")[0])


# moe_gmm's checked cases (M, act, dtype, inputs) per config.  granite: M
# 320 (a 1024-token prefill), 640 (the 4 x 512 fixed batch), 8 (decode
# with 8 slots), a ragged 100, gelu, f32, and 1280 (the train families'
# rank batch of 4 x 1024: 8 groups x capacity 160).  phi3.5-moe (d 4096): M 160
# (a 1024-token prefill, 2 groups x capacity 80) and M 2 (8-lane decode:
# capacity max(1, top_k)), and f32.  "model": the model's init for the
# weights, x ~ N(0, 1); "common": ref.common_part_inputs, whose h has a
# large part common to each row (one bf16 rounding of h fails it).
GMM_CASES = {
    "granite-moe-1b-a400m": [
        (320, "silu", "bfloat16", "model"), (640, "silu", "bfloat16", "model"),
        (8, "silu", "bfloat16", "model"), (100, "silu", "bfloat16", "model"),
        (320, "gelu", "bfloat16", "model"), (320, "silu", "float32", "model"),
        (8, "silu", "float32", "model"), (320, "silu", "bfloat16", "common"),
        (1280, "silu", "bfloat16", "model"),
        (1280, "silu", "bfloat16", "common")],
    "phi3.5-moe-42b-a6.6b": [
        (160, "silu", "bfloat16", "model"), (2, "silu", "bfloat16", "model"),
        (160, "silu", "float32", "model"), (160, "silu", "bfloat16", "common"),
        (2, "silu", "bfloat16", "common")]}


def _gmm_cublas(torch, x, w1, w2, w3, act):
    """The same FFN composed of cuBLAS products and elementwise ops, as a
    framework would run it: three ``torch.bmm`` (two for gelu) in the
    inputs' dtype, h rounded to it (another function than the kernel's,
    whose h stays f32; several launches, not one call)."""
    import torch.nn.functional as F
    g = torch.bmm(x, w1)
    h = F.silu(g) * torch.bmm(x, w3) if act == "silu" else F.gelu(
        g, approximate="tanh")
    return torch.bmm(h, w2)


def check_moe_gmm(torch, cfg):
    """moe_gmm against its plain version at a config's shapes (GMM_CASES).
    Times: the kernel route (for bf16 its two launches), the plain
    version, and for bf16 the cuBLAS composition (``_gmm_cublas``)."""
    from repro_torch.kernels.moe_gmm import ops as go
    from repro_torch.kernels.moe_gmm import ref as gr
    from repro_torch.models import moe as moe_mod

    cases = GMM_CASES[cfg.name]
    gen = torch.Generator(device="cuda").manual_seed(21)
    w = {}
    for dname in sorted({c[2] for c in cases if c[3] == "model"}):
        w[dname] = moe_mod.init_moe(gen, cfg.with_(dtype=dname),
                                    device="cuda")
    e, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    rows = []
    for m, act, dname, inputs in cases:
        if inputs == "common":
            x, w1, w2, w3 = gr.common_part_inputs(
                e, m, d, ff, dtype=getattr(torch, dname), device="cuda",
                seed=m)
            p = {"w1": w1, "w2": w2, "w3": w3}
        else:
            p = w[dname]
            x = torch.randn((e, m, d), generator=gen, device="cuda").to(
                getattr(torch, dname))
        out = go.expert_ffn_kernel_layout(x, p["w1"], p["w2"], p["w3"],
                                          act=act)
        ref = gr.expert_ffn_ref(x, p["w1"], p["w2"], p["w3"], act=act)
        torch.cuda.synchronize()
        tol = GMM_TOL[dname]
        scale = max(1.0, ref.float().abs().max().item())
        ok = bool(torch.isfinite(out.float()).all()) and torch.allclose(
            out.float(), ref.float(), atol=tol * scale, rtol=tol)
        ms = _time_ms(lambda: go._launch(x, p["w1"], p["w2"], p["w3"], act))
        plain_ms = _time_ms(lambda: gr.expert_ffn_ref(
            x, p["w1"], p["w2"], p["w3"], act=act), iters=5)
        cublas_ms = None if dname == "float32" else _time_ms(
            lambda: _gmm_cublas(torch, x, p["w1"], p["w2"], p["w3"], act))
        bound_ms, bound_by, flops, nbytes, f32_ms = _gmm_bound(
            e, m, d, ff, act, dname, x.element_size())
        row = {"arch": cfg.name, "E": e, "M": m, "d": d, "ff": ff,
               "inputs": inputs,
               "grids": go.launch_grid(e, m, d, ff, x.dtype), "act": act,
               "dtype": dname, "max_abs_err": (out.float() - ref.float())
               .abs().max().item(), "ref_absmax": scale,
               "atol": tol * scale, "rtol": tol, "ok": ok, "ms": ms,
               "plain_ms": plain_ms, "library_ms": None,
               "cublas_composition_ms": cublas_ms,
               "cublas_composition": "torch.bmm per product + the "
                                     "activation, h in bf16 (another "
                                     "function; several calls)",
               "bound_ms": bound_ms,
               "bound_by": bound_by, "bound_f32_cores_ms": f32_ms,
               "tflops": flops / (ms * 1e-3) / 1e12,
               "gbytes_per_s": nbytes / ms * 1e-6}
        rows.append(row)
        print(f"kernel-check moe_gmm {json.dumps(row)}", flush=True)
    del w
    torch.cuda.empty_cache()
    go.reset_launches()
    return rows


# moe_gmm backward's checked cases (E, M, d, ff, act, dtype, inputs):
# granite's training shape (E 32, d 1024, ff 512; M 1280 = 8 groups x
# capacity 160 of a 4 x 1024-token rank batch) and phi3.5-moe's prefill
# shape (E 16, d 4096, ff 6400, M 160; kernel level only: phi3.5 does not
# train here), both through the wgmma design (ops.bwd_design); two shapes
# TMA cannot describe (ff 70, d 130) through the mma.sync design.
# "model": the model's init for the weights, x and dy ~ N(0, 1);
# "common": ref.common_part_inputs with ref.common_part_grad (h has a large
# part common to each row and dy's columns sum to zero over M: one bf16
# rounding of h fails dw2, and the planted copy must); "random": x ~
# N(0, 0.25), the weights ~ N(0, 0.0025), dy ~ N(0, 1) (the emulated
# tests' draw).
GMM_BWD_CASES = [
    (32, 1280, 1024, 512, "silu", "bfloat16", "model"),
    (32, 1280, 1024, 512, "gelu", "bfloat16", "model"),
    (32, 1280, 1024, 512, "silu", "float32", "model"),
    (32, 1280, 1024, 512, "gelu", "float32", "model"),
    (32, 1280, 1024, 512, "silu", "bfloat16", "common"),
    (16, 160, 4096, 6400, "silu", "bfloat16", "model"),
    (16, 160, 4096, 6400, "silu", "float32", "model"),
    (16, 160, 4096, 6400, "silu", "bfloat16", "common"),
    (2, 33, 72, 70, "gelu", "bfloat16", "random"),
    (1, 17, 130, 64, "silu", "bfloat16", "random")]
GRAD_NAMES = ("dx", "dw1", "dw2", "dw3")


def _gmm_bwd_bound(e, m, d, ff, act, dtype_name, esize):
    """Least time of the FFN's backward on this input: the larger of its
    bytes (x, dy and the weights read once; dx and the weight gradients
    written once) over HBM bandwidth and its operations (8 products of
    2 E M d ff for SwiGLU, 5 for gelu) over the peak of the inputs'
    type (moe_gmm/ops.py ``bwd_work``)."""
    from repro_torch.kernels.moe_gmm import ops
    flops, nbytes = ops.bwd_work(e, m, d, ff, act, esize)
    return (*_roof(flops, nbytes, dtype_name), flops, nbytes)


def _max_errs(got, ref):
    return [(g.float() - r.float()).abs().max().item()
            for g, r in zip(got, ref)]


def pass_ms(torch, fn, iters=10):
    """Device time of each CUDA kernel that ``fn`` launches, ms a call
    (torch.profiler, after a warm-up): a multi-pass kernel's passes."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0)
        if t:       # "void (anonymous namespace)::ml_x<T>(...)" -> "ml_x"
            name = e.key.replace("(anonymous namespace)::", "")
            name = re.split(r"[(<]", name.removeprefix("void "))[0]
            name = name.split("::")[-1]
            out[name] = out.get(name, 0.0) + t / iters / 1000
    return out


def check_moe_gmm_bwd(torch):
    """moe_gmm's backward kernel against autograd of its plain version
    (``ref.expert_ffn_grads_ref``) at GMM_BWD_CASES, with TF32 off, each
    gradient within ``ref.grads_close``, through the design
    ``ops.bwd_design`` names (each row's ``design``: the one whose count
    rose); on the common-part cases also the planted copy
    (``ref.BWD_ROUND_FAULT``: h rounded once in dw2), which must fail dw2
    and only dw2.  Times: the kernel (its three launches, and each
    launch's device time on the bf16 rows, ``launch_ms``), autograd of
    the plain version, and for bf16 autograd of the cuBLAS composition
    (``_gmm_cublas``: h in bf16, another function; several calls)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_gmm import ops as go
    from repro_torch.kernels.moe_gmm import ref as gr
    from repro_torch.models import moe as moe_mod

    fault_lib = _build.load("moe_gmm_bwd_fault", _gmm_bwd_fault_source(),
                            go._BWD_SIG)
    configs = {(c.n_experts, c.d_model, c.moe_d_ff): c for c in (
        get_config("granite-moe-1b-a400m"),
        get_config("phi3.5-moe-42b-a6.6b"))}
    gen = torch.Generator(device="cuda").manual_seed(31)
    rows = []
    for e, m, d, ff, act, dname, inputs in GMM_BWD_CASES:
        dt = getattr(torch, dname)
        cfg = configs.get((e, d, ff))
        if inputs == "common":
            x, w1, w2, w3 = gr.common_part_inputs(e, m, d, ff, dtype=dt,
                                                  device="cuda", seed=m)
            dy = gr.common_part_grad(e, m, d, dtype=dt, device="cuda",
                                     seed=m + 1)
        elif inputs == "random":
            x = (torch.randn((e, m, d), generator=gen, device="cuda")
                 * 0.5).to(dt)
            w1, w3 = ((torch.randn((e, d, ff), generator=gen, device="cuda")
                       * 0.05).to(dt) for _ in range(2))
            w2 = (torch.randn((e, ff, d), generator=gen, device="cuda")
                  * 0.05).to(dt)
            dy = torch.randn((e, m, d), generator=gen, device="cuda").to(dt)
        else:
            p = moe_mod.init_moe(gen, cfg.with_(dtype=dname), device="cuda")
            w1, w2, w3 = p["w1"], p["w2"], p["w3"]
            x, dy = (torch.randn((e, m, d), generator=gen,
                                 device="cuda").to(dt) for _ in range(2))
        before = dict(go.bwd_design_launches)
        got = go._launch_bwd(x, w1, w2, w3, dy, act)
        took = [k for k in go.BWD_DESIGNS
                if go.bwd_design_launches[k] > before[k]]
        again = go._launch_bwd(x, w1, w2, w3, dy, act)
        ref = gr.expert_ffn_grads_ref(x, w1, w2, w3, dy, act=act)
        torch.cuda.synchronize()
        tol = GMM_TOL[dname]
        oks, errs = gr.grads_close(got, ref, tol), _max_errs(got, ref)
        bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        design = go.bwd_design(e, m, d, ff, dt)
        row = {"arch": cfg.name if cfg else None, "E": e, "M": m, "d": d,
               "ff": ff, "act": act, "dtype": dname, "inputs": inputs,
               "design": took[0] if len(took) == 1 else took,
               "ok_" + "_".join(GRAD_NAMES): oks,
               "max_abs_err_" + "_".join(GRAD_NAMES): errs,
               "max_abs_err": max(errs), "rtol": tol,
               "atol": "rtol x each gradient's largest magnitude",
               "bit_equal_rerun": bit_equal}
        ok = all(oks) and bit_equal and took == [design]
        if inputs == "common":
            with mock.patch.object(go, "bwd_lib", lambda: fault_lib):
                bad = go._launch_bwd(x, w1, w2, w3, dy, act)
            foks, ferrs = gr.grads_close(bad, ref, tol), _max_errs(bad, ref)
            row.update(fault_ok=foks, fault_max_abs_err=ferrs)
            ok = ok and foks == [True, True, False, True]
            del bad
        ms = _time_ms(lambda: go._launch_bwd(x, w1, w2, w3, dy, act),
                      iters=10)
        plain_ms = _time_ms(lambda: gr.expert_ffn_grads_ref(
            x, w1, w2, w3, dy, act=act), iters=3, warmup=1)
        comp_ms = launch_ms = None
        if dname == "bfloat16":
            launch_ms = pass_ms(torch, lambda: go._launch_bwd(
                x, w1, w2, w3, dy, act), iters=5)
            leaves = [t.detach().clone().requires_grad_()
                      for t in (x, w1, w2, w3)]
            yc = _gmm_cublas(torch, *leaves, act)
            comp_ms = _time_ms(lambda: torch.autograd.grad(
                yc, leaves, dy, retain_graph=True, allow_unused=True),
                iters=10)
            del yc, leaves
        bound_ms, bound_by, flops, nbytes = _gmm_bwd_bound(
            e, m, d, ff, act, dname, x.element_size())
        row.update(ok=ok, ms=ms, launch_ms=launch_ms, plain_ms=plain_ms,
                   library_ms=None,
                   cublas_composition_ms=comp_ms,
                   cublas_composition="autograd of torch.bmm per product "
                                      "+ the activation, h in bf16 "
                                      "(another function; several calls)",
                   bound_ms=bound_ms, bound_by=bound_by,
                   tflops=flops / (ms * 1e-3) / 1e12,
                   gbytes_per_s=nbytes / ms * 1e-6)
        rows.append(row)
        print(f"kernel-check moe_gmm_bwd {json.dumps(row)}", flush=True)
        del got, ref, x, dy, w1, w2, w3
    torch.cuda.empty_cache()
    go.reset_launches()
    return rows


def _scan_bound(b, length, h, p, n, q, esize, dtype_name):
    """Least time of the chunked scan on this input: the larger of its
    bytes (x, dt, a, b, c read once, y and the final state written once)
    over HBM bandwidth and its operations over the peak of the inputs'
    type: C B^T once per (batch, chunk) over the causal pairs, the masked
    (q x q) product per head, and the y_inter and state products per
    head.  Also the operations over the f32 CUDA-core peak
    (mamba_scan/ops.py ``work``)."""
    from repro_torch.kernels.mamba_scan import ops
    flops, nbytes = ops.work(b, length, h, p, n, q, esize)
    return (*_roof(flops, nbytes, dtype_name), flops, nbytes,
            _roof(flops, nbytes, "float32")[0])


# The scan's gates (the tests' SCAN_GATES): "model" is the model's own
# init, a = -(1..H), with dt = softplus(N(0, 1)); "slow" draws dt =
# softplus(N(-4.6, 0.1)), about 0.01 (trained Mamba2's dt range is
# [1e-3, 0.1]), with a = -exp(N(0, 0.3)), so a 64-token chunk decays by
# about e^-0.64 and the state carries over several chunks; under the
# model's gates exp(sum dt a) over a chunk is e^-45 or less.
SCAN_GATES = {"model": (0.0, 1.0), "slow": (-4.6, 0.1)}


def check_mamba_scan(torch, cfg):
    """mamba_scan against its plain version at zamba2's shapes (H 80, P 64,
    N 64, chunk 64), with the model's gates (SCAN_GATES): L 64, 256 and
    1024 at B 1, L 40 (shorter than the chunk), B 4 at L 512; and with
    slow gates at L 1024, 256 and B 4 x 512, whose rows must read a
    ``carry_share`` above 0.1; bf16 and f32; and one bf16 row whose state
    has a large common part that C S^T cancels (``"inputs": "common"``:
    one rounding of the state as an operand fails it).  No PyTorch call
    computes the scan."""
    from repro_torch.kernels.mamba_scan import ops as so
    from repro_torch.kernels.mamba_scan import ref as sr
    from repro_torch.models import ssm as ssm_mod

    _, h = ssm_mod.dims(cfg)
    p, n, chunk = cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk
    cases = [(1, 64, "bfloat16", "model"), (1, 256, "bfloat16", "model"),
             (1, 1024, "bfloat16", "model"), (1, 40, "bfloat16", "model"),
             (4, 512, "bfloat16", "model"), (1, 1024, "float32", "model"),
             (1, 40, "float32", "model"), (4, 512, "float32", "model")] + [
        (b, length, d, "slow") for d in ("bfloat16", "float32")
        for b, length in ((1, 1024), (1, 256), (4, 512))]
    cases = [c + ("random",) for c in cases] + [
        (1, 1024, "bfloat16", "slow", "common")]
    gen = torch.Generator(device="cuda").manual_seed(22)
    rows = []
    for b, length, dname, gates, inputs in cases:
        dt_ = getattr(torch, dname)
        x = (torch.randn((b, length, h, p), generator=gen, device="cuda")
             * 0.5).to(dt_)
        mean, std = SCAN_GATES[gates]
        dt = torch.nn.functional.softplus(
            torch.randn((b, length, h), generator=gen, device="cuda") * std
            + mean)
        bb, cc = (torch.randn((b, length, n), generator=gen, device="cuda")
                  * 0.5 for _ in range(2))
        if inputs == "common":   # S large, C S^T cancelling its common part
            bb, cc = bb + 32.0, cc - cc.mean(-1, keepdim=True)
        bb, cc = bb.to(dt_), cc.to(dt_)
        if gates == "model":
            a = -torch.arange(1, h + 1, dtype=torch.float32, device="cuda")
        else:
            a = -torch.exp(torch.randn((h,), generator=gen, device="cuda")
                           * 0.3)
        y, s = so.ssd(x, dt, a, bb, cc, chunk=chunk)
        yr, sr_ = sr.ssd_chunked(x, dt, a, bb, cc, chunk)
        torch.cuda.synchronize()
        tol = SCAN_TOL[dname]
        share = sr.carry_share(x, dt, a, bb, cc, chunk, sr_)
        ok = (bool(torch.isfinite(y.float()).all())
              and torch.allclose(y.float(), yr.float(), atol=tol["y"][0],
                                 rtol=tol["y"][1])
              and torch.allclose(s, sr_, atol=tol["state"][0],
                                 rtol=tol["state"][1])
              and (gates != "slow" or share > 0.1))
        ms = _time_ms(lambda: so.ssd(x, dt, a, bb, cc, chunk=chunk))
        plain_ms = _time_ms(lambda: sr.ssd_chunked(x, dt, a, bb, cc, chunk),
                            iters=5)
        q = min(chunk, length)
        bound_ms, bound_by, flops, nbytes, f32_ms = _scan_bound(
            b, length, h, p, n, q, x.element_size(), dname)
        row = {"B": b, "L": length, "H": h, "P": p, "N": n, "chunk": q,
               "dtype": dname, "gates": gates, "inputs": inputs,
               "carry_share": share,
               "max_abs_err": (y.float() - yr.float()).abs().max().item(),
               "state_max_abs_err": (s - sr_).abs().max().item(),
               "tol": tol, "ok": ok, "ms": ms, "plain_ms": plain_ms,
               "library_ms": None, "bound_ms": bound_ms,
               "bound_by": bound_by, "bound_f32_cores_ms": f32_ms,
               "tflops": flops / (ms * 1e-3) / 1e12,
               "gbytes_per_s": nbytes / ms * 1e-6}
        rows.append(row)
        print(f"kernel-check mamba_scan {json.dumps(row)}", flush=True)
    so.reset_launches()
    return rows


# mlstm: f32 sums over hd_k = 1024 terms in another order than the plain
# version's; their error follows the size of the terms, so the absolute
# tolerance of h and of the state scales with its largest magnitude (as
# moe_gmm's).  bf16 h is rounded once from f32 in both, so the two differ
# by at most one bf16 ulp (2^-8 to 2^-7 of the value) where their f32
# values straddle a rounding boundary: atol and rtol of two ulps, 8e-3
# (of max|h| and of the value).  m is a log-domain stabiliser (the JAX
# kernel test's atol 1e-3).
MLSTM_TOL = {"bfloat16": 8e-3, "float32": 1e-4}
# The forget gates of the check: "jax" draws logf = -softplus(N(0, 1)) as
# the JAX kernel test does (about -0.8 a token: C and n forget the last
# chunk within ~20 tokens, so the carry between chunks is exp(-100), 0 in
# f32); "model" is log sigmoid(N(3, 1)), the model's forget bias of 3
# (about -0.08 a token); "slow" is log sigmoid(N(4.6, 0.1)), about -0.01,
# so that C and n carry over several chunks and a fault in the carry
# shows in C, n and h.
MLSTM_GATES = {"jax": (-1.0, 0.0, 1.0), "model": (1.0, 3.0, 1.0),
               "slow": (1.0, 4.6, 0.1)}


def _mlstm_logf(torch, shape, gates, gen):
    """logf for the gate kind ``gates`` (see MLSTM_GATES)."""
    sign, mean, std = MLSTM_GATES[gates]
    x = torch.randn(shape, generator=gen, device="cuda") * std + mean
    if sign < 0:
        return -torch.nn.functional.softplus(x)
    return torch.nn.functional.logsigmoid(x)


def _mlstm_carry_share(mr, q, k, v, li, lf, st, ck, c, m):
    """How much of the final C the chunks before the last carry into it:
    max |C - C'| / max |C|, where C' is the plain version's final C from
    the last chunk alone (zero state), both unstabilised.  About 0 with
    the JAX test's gates, well above the tolerance with slow ones."""
    lo = (q.shape[1] - 1) // ck * ck
    if lo == 0 and st is None:
        return 0.0
    _, (c1, _, m1) = mr.mlstm_chunked(
        *(t[:, lo:] for t in (q, k, v, li, lf)), None, ck)
    full = c * (m - m.amax())[..., None, None].exp()
    last = c1 * (m1 - m.amax())[..., None, None].exp()
    return ((full - last).abs().max() / full.abs().max()).item()


def _mlstm_bound(b, length, h, hd, q, state, esize, dtype_name):
    """Least time of the chunked mLSTM on this input: the larger of its
    bytes (q, k, v and the gates read once, h and the final state written
    once, an initial state read once) over HBM bandwidth and its
    operations over the peak of the inputs' type: per (b, h) and chunk of
    c tokens, S and S V over the c (c + 1) / 2 causal pairs, Q C^T and
    the C update over c hd^2 (Q C^T and q . n not in the first chunk
    when the state is zero), the n update and q . n over c hd.  Also the
    operations over the f32 CUDA-core peak, on which the kernel runs
    them (mlstm/ops.py ``work``)."""
    from repro_torch.kernels.mlstm import ops
    flops, nbytes = ops.work(b, length, h, hd, q, bool(state), esize)
    return (*_roof(flops, nbytes, dtype_name), flops, nbytes,
            _roof(flops, nbytes, "float32")[0])


def check_mlstm(torch, cfg):
    """mlstm against its plain version at xlstm-1.3b's shapes (H 4, hd
    1024, chunk 128; q, k, v ~ N(0, 1), logi ~ N(-1, 1)): a 1024-token
    prefill, a ragged 1000, the 4 x 512 batch and 300 tokens from a
    nonzero initial state, each with the model's forget gates in bf16
    and f32 and with slow ones (MLSTM_GATES) in f32, the 1024-token one
    with slow gates in bf16 too; then the JAX tests' small shapes (hd
    16-64) with their gates; last the 300-token bf16 case with slow
    gates whose initial C has a large common part that Q C^T cancels
    (``"inputs": "common"``: one rounding of C as an operand fails it),
    and prefill_32k's 32768 tokens (slice 18; bf16, B 1).  Each row
    gives ``carry_share``, how much of the final C the earlier
    chunks carry.  Times: the kernel, the
    plain version, and one ``torch.bmm`` of Q C^T over the whole
    sequence (partial: no PyTorch call computes the function).  Last,
    the precision row at xlstm-1.3b's training shape (B 2, L 512, bf16,
    slow gates): ``ref.precision`` (h and the final C against float64,
    the plain version as the yardstick) must pass, and fail on the copy
    with its f32 operands in two bf16 parts (``fault_ok`` false), whose
    time is the row's ``two_parts_ms``."""
    from repro_torch.kernels.mlstm import ops as mo
    from repro_torch.kernels.mlstm import ref as mr
    from repro_torch.models import xlstm as xlstm_mod

    _, hd = xlstm_mod.mlstm_dims(cfg)
    h, chunk = cfg.n_heads, 128
    big = [(1, 1024, h, hd, chunk, False), (1, 1000, h, hd, chunk, False),
           (4, 512, h, hd, chunk, False), (1, 300, h, hd, chunk, True)]
    small = [(2, 128, 2, 32, 32, False), (1, 256, 4, 64, 64, False),
             (2, 64, 1, 16, 16, False), (2, 100, 2, 48, 32, True)]
    cases = [c + ("model", d) for d in ("bfloat16", "float32") for c in big] \
        + [c + ("slow", "float32") for c in big] \
        + [big[0] + ("slow", "bfloat16")] \
        + [c + ("jax", "float32") for c in small] \
        + [small[0] + ("jax", "bfloat16")]
    cases = [c + ("random",) for c in cases] + [
        big[3] + ("slow", "bfloat16", "common"),
        (1, 32768, h, hd, chunk, False, "model", "bfloat16", "random")]
    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = []
    for b, length, nh, d, ck, with_state, gates, dname, inputs in cases:
        dt_ = getattr(torch, dname)
        q, k, v = (torch.randn((b, length, nh, d), generator=gen,
                               device="cuda") for _ in range(3))
        if inputs == "common":   # C large, Q C^T cancelling its common part
            q = q - q.mean(-1, keepdim=True)
        q, k, v = q.to(dt_), k.to(dt_), v.to(dt_)
        li = torch.randn((b, length, nh), generator=gen, device="cuda") - 1
        lf = _mlstm_logf(torch, (b, length, nh), gates, gen)
        st = None
        if with_state:
            st = (torch.randn((b, nh, d, d), generator=gen,
                              device="cuda") * 0.3
                  + (30.0 if inputs == "common" else 0.0),
                  torch.randn((b, nh, d), generator=gen, device="cuda") * .3,
                  torch.randn((b, nh), generator=gen, device="cuda"))
        out, (c, n, m) = mo.mlstm(q, k, v, li, lf, st, chunk=ck)
        ref, (cr, nr, m_r) = mr.mlstm_chunked(q, k, v, li, lf, st, ck)
        torch.cuda.synchronize()
        tol = MLSTM_TOL[dname]
        h_scale = max(1.0, ref.float().abs().max().item())
        c_scale = max(1.0, cr.abs().max().item())
        n_scale = max(1.0, nr.abs().max().item())
        ok = (bool(torch.isfinite(out.float()).all())
              and torch.allclose(out.float(), ref.float(),
                                 atol=tol * h_scale, rtol=tol)
              and torch.allclose(c, cr, atol=1e-4 * c_scale, rtol=1e-3)
              and torch.allclose(n, nr, atol=1e-4 * n_scale, rtol=1e-3)
              and torch.allclose(m, m_r, atol=1e-3, rtol=0))
        ms = _time_ms(lambda: mo._launch(q, k, v, li, lf, st, ck),
                      iters=10)
        long = length > 4096             # prefill_32k's: the plain once
        plain_ms = _time_ms(lambda: mr.mlstm_chunked(q, k, v, li, lf, st,
                                                     ck),
                            iters=1 if long else 3, warmup=1 if long else 3)
        qb = q.transpose(1, 2).reshape(b * nh, length, d)
        cb = cr.to(dt_).reshape(b * nh, d, d)
        part_ms = _time_ms(lambda: torch.bmm(qb, cb.transpose(1, 2)))
        bound_ms, bound_by, flops, nbytes, f32_ms = _mlstm_bound(
            b, length, nh, d, min(ck, length), with_state,
            q.element_size(), dname)
        row = {"B": b, "L": length, "H": nh, "hd": d, "chunk": ck,
               "state": with_state, "gates": gates, "dtype": dname,
               "inputs": inputs,
               "logf_mean": lf.mean().item(),
               "carry_share": _mlstm_carry_share(mr, q, k, v, li, lf, st,
                                                 ck, cr, m_r),
               "max_abs_err": (out.float() - ref.float()).abs().max()
               .item(), "c_max_abs_err": (c - cr).abs().max().item(),
               "n_max_abs_err": (n - nr).abs().max().item(),
               "m_max_abs_err": (m - m_r).abs().max().item(),
               "h_absmax": h_scale, "c_absmax": c_scale,
               "atol": tol * h_scale, "rtol": tol, "ok": ok, "ms": ms,
               "plain_ms": plain_ms, "library_ms": None,
               "nearest_call_ms_partial": part_ms,
               "nearest_call": "torch.bmm(q, C^T)", "bound_ms": bound_ms,
               "bound_by": bound_by, "bound_f32_cores_ms": f32_ms,
               "tflops": flops / (ms * 1e-3) / 1e12,
               "gbytes_per_s": nbytes / ms * 1e-6}
        rows.append(row)
        print(f"kernel-check mlstm {json.dumps(row)}", flush=True)
    rows.append(_mlstm_precision_row(torch, mo, mr, h, hd, chunk))
    mo.reset_launches()
    torch.cuda.empty_cache()
    return rows


def _mlstm_precision_row(torch, mo, mr, h, hd, chunk):
    """The forward's precision at xlstm-1.3b's training shape, on the
    kernel and on its two-part copy (see check_mlstm)."""
    from repro_torch.kernels import _build

    ins = mr.grad_inputs(2, 512, h, hd, gates="slow", dtype=torch.bfloat16,
                         seed=1536, device="cuda")[:5]
    fault = _build.load("mlstm_parts_fault", _mlstm_parts_fault_source(),
                        mo._SIG)
    row = {"B": 2, "L": 512, "H": h, "hd": hd, "chunk": chunk,
           "gates": "slow", "dtype": "bfloat16", "inputs": "precision"}
    for tag, patch in (("kernel", None), ("two_parts", fault)):
        ctx = mock.patch.object(mo, "lib", lambda: patch) if patch \
            else contextlib.nullcontext()
        with ctx:
            out, (c, _, _) = mo.mlstm(*ins, chunk=chunk)
            torch.cuda.synchronize()
            res = mr.precision(out, c, *ins, chunk)
            ms = _time_ms(lambda: mo._launch(*ins, None, chunk), iters=10)
        if tag == "kernel":
            row.update(res, ms=ms)
        else:
            row.update(fault="two_parts", fault_ok=res["ok"],
                       fault_h_off=res["h_off"], fault_c_err=res["c_err"],
                       two_parts_ms=ms)
    print(f"kernel-check mlstm {json.dumps(row)}", flush=True)
    assert row["ok"] and not row["fault_ok"], row
    return row


# The backward kernels' tolerance (rtol, and atol times each gradient's
# largest magnitude): f32 sums of up to chunk x H (mamba_scan) or hd
# (mlstm) terms in another order; bf16 adds one rounding of the x-, q-,
# k- and v-shaped gradients.
SCAN_BWD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}


def _grads_check(torch, got, ref, tol):
    """Per gradient: finite and within rtol ``tol`` and an atol of ``tol``
    times its largest magnitude of ``ref``; and each largest error."""
    oks = [bool(torch.isfinite(g.float()).all()) and torch.allclose(
        g.float(), r.float(), rtol=tol,
        atol=tol * max(1.0, r.float().abs().max().item()))
        for g, r in zip(got, ref)]
    return oks, _max_errs(got, ref)


def _scan_bwd_bound(b, length, h, p, n, q, esize, dtype_name):
    """Least time of the scan's backward on this input: the larger of its
    bytes (x, dy, b, c, dt and a read once; dx, db, dc, ddt and da written
    once) over HBM bandwidth and its operations over the peak of the
    inputs' type: per (batch, chunk) C B^T over the causal pairs, and per
    head dY X^T, M1^T dY over the pairs and M2^T C, M2 B over the pairs,
    and the four q P N products of the state (dS B, X dS, dY S_in, the dS
    update).  Also the operations over the f32 CUDA-core peak, on which
    the kernel runs them (mamba_scan/ops.py ``bwd_work``)."""
    from repro_torch.kernels.mamba_scan import ops
    flops, nbytes = ops.bwd_work(b, length, h, p, n, q, esize)
    return (*_roof(flops, nbytes, dtype_name), flops, nbytes,
            _roof(flops, nbytes, "float32")[0])


def check_mamba_scan_bwd(torch, cfg, b=2, length=1024):
    """mamba_scan's backward kernel against autograd of its plain version
    (``ref.ssd_chunked_grads``) and against an f32 witness (autograd of
    the plain version on the inputs widened to f32), at zamba2's training
    shape (rank batch ``b`` x ``length``, H 80, P 64, N 64, chunk 64): in
    bf16 with the JAX kernel tests' gates, the model's and slow ones
    (``ref.SCAN_GATES``; a slow row passes only with a ``carry_share``
    above 0.1), f32 with slow ones, one slow bf16 row with a gradient of
    the final state, and one bf16 row of common-part inputs
    (``ref.scan_inputs(inputs="common")``: states with a large common
    part that dY S_in cancels).  Each row: the route that ran
    (``ops.bwd_design_launches``) and its grid's blocks, the largest
    errors, a rerun's bit-equality, the kernel's time, its bound, autograd
    of the plain version's time; the slow bf16 rows also run the planted
    copy ``ref.BWD_CARRY_FAULT``, the common-part row
    ``ref.BWD_ROUND_FAULT`` (S_in rounded once), each of which must fail
    (``fault_ok`` false).  Every bf16 row must run on the tensor-core
    route ("mma.sync"), f32 on "fma"."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import ops as so
    from repro_torch.kernels.mamba_scan import ref as sr
    from repro_torch.models import ssm as ssm_mod

    faults = {"carry": ("carry dropped", _build.load(
        "mamba_scan_bwd_fault", _scan_bwd_fault_source(), so._BWD_SIG)),
        "round": ("S_in rounded once", _build.load(
            "mamba_scan_bwd_round_fault", _scan_bwd_fault_source("round"),
            so._BWD_SIG))}
    ptxas = _ptxas("mamba_scan_bwd")
    _, h = ssm_mod.dims(cfg)
    p, n, chunk = cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk
    cases = [("bfloat16", "jax", False, "random"),
             ("bfloat16", "model", False, "random"),
             ("bfloat16", "slow", False, "random"),
             ("bfloat16", "slow", True, "random"),
             ("bfloat16", "slow", False, "common"),
             ("float32", "slow", False, "random")]
    rows = []
    for dname, gates, with_ds, inputs in cases:
        dt_ = getattr(torch, dname)
        x, dt, a, bb, cc, dy = sr.scan_inputs(
            b, length, h, p, n, gates=gates, inputs=inputs, dtype=dt_,
            seed=24, device="cuda")
        ds = (torch.randn((b, h, p, n), device="cuda") if with_ds else None)
        so.reset_launches()
        got = so._launch_bwd(x, dt, a, bb, cc, dy, ds, chunk)
        route = [k for k, v in so.bwd_design_launches.items() if v][0]
        again = so._launch_bwd(x, dt, a, bb, cc, dy, ds, chunk)
        ref = sr.ssd_chunked_grads(x, dt, a, bb, cc, chunk, dy, ds)
        wit = sr.ssd_chunked_grads(x.float(), dt, a, bb.float(), cc.float(),
                                   chunk, dy.float(), ds)
        torch.cuda.synchronize()
        tol = SCAN_BWD_TOL[dname]
        oks, errs = _grads_check(torch, got, ref, tol)
        _, werrs = _grads_check(torch, got, wit, tol)
        bit_equal = all(torch.equal(u, w) for u, w in zip(got, again))
        _, s = sr.ssd_chunked(x, dt, a, bb, cc, chunk)
        share = sr.carry_share(x, dt, a, bb, cc, chunk, s)
        ok = all(oks) and bit_equal and (gates != "slow" or share > 0.1) \
            and route == so.bwd_design(dt_)
        blocks = (length // chunk) * h * b if route == "mma.sync" else h * b
        row = {"B": b, "L": length, "H": h, "P": p, "N": n, "chunk": chunk,
               "dtype": dname, "gates": gates, "ds_fin": with_ds,
               "inputs": inputs, "route": route, "grid_blocks": blocks,
               "carry_share": share,
               "ok_dx_ddt_da_db_dc": oks,
               "max_abs_err_dx_ddt_da_db_dc": errs,
               "witness_f32_max_abs_err": werrs,
               "max_abs_err": max(errs), "rtol": tol,
               "atol": "rtol x each gradient's largest magnitude",
               "bit_equal_rerun": bit_equal, "ptxas": ptxas}
        fault = ("round" if inputs == "common" else
                 "carry" if gates == "slow" and dname == "bfloat16" else None)
        if fault:
            name, lib = faults[fault]
            with mock.patch.object(so, "bwd_lib", lambda: lib):
                bad = so._launch_bwd(x, dt, a, bb, cc, dy, ds, chunk)
            foks, ferrs = _grads_check(torch, bad, ref, tol)
            row.update(fault=name, fault_ok=all(foks),
                       fault_ok_each=foks, fault_max_abs_err=ferrs)
            ok = ok and not all(foks)
            del bad
        ms = _time_ms(lambda: so._launch_bwd(x, dt, a, bb, cc, dy, ds,
                                             chunk), iters=10)
        plain_ms = _time_ms(lambda: sr.ssd_chunked_grads(
            x, dt, a, bb, cc, chunk, dy, ds), iters=3, warmup=1)
        bound_ms, bound_by, flops, nbytes, f32_ms = _scan_bwd_bound(
            b, length, h, p, n, chunk, x.element_size(), dname)
        row.update(ok=ok, ms=ms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_f32_cores_ms=f32_ms,
                   tflops=flops / (ms * 1e-3) / 1e12,
                   gbytes_per_s=nbytes / ms * 1e-6)
        rows.append(row)
        print(f"kernel-check mamba_scan_bwd {json.dumps(row)}", flush=True)
        del got, again, ref, wit, x, dt, a, bb, cc, dy
    torch.cuda.empty_cache()
    so.reset_launches()
    return rows


def _mlstm_bwd_bound(b, length, h, hd, q, esize, dtype_name):
    """Least time of the mLSTM's backward from the zero state on this
    input: the larger of its bytes (q, k, v, dh and the gates read once;
    dq, dk, dv, dlogi and dlogf written once) over HBM bandwidth and its
    operations over the peak of the inputs' type: per (b, h) and chunk of
    c tokens, Q K^T, dH V^T, d ds K, d ds^T Q and (s rinv)^T dH over the c
    (c + 1) / 2 causal pairs; the chunk's own dC and C^T dh over c hd^2
    where a state enters it (not the first chunk); dC k and dC^T v over c
    hd^2 where a gradient leaves it (not the last); the states C over c
    hd^2 (not the last).  Also the operations over the f32 CUDA-core
    peak, on which the kernel runs them (mlstm/ops.py ``bwd_work``)."""
    from repro_torch.kernels.mlstm import ops
    flops, nbytes = ops.bwd_work(b, length, h, hd, q, esize)
    return (*_roof(flops, nbytes, dtype_name), flops, nbytes,
            _roof(flops, nbytes, "float32")[0])


def check_mlstm_bwd(torch, cfg, b=2, length=512):
    """mlstm's backward kernel against autograd of its plain version from
    the zero state (``ref.mlstm_chunked_grads``) and against an f32
    witness (the same on the inputs widened to f32), at xlstm-1.3b's
    training shape (rank batch ``b`` x ``length``, 4 heads of hd 1024,
    chunk 128; ``ref.grad_inputs``): bf16 with slow forget gates on
    inputs whose floor binds on few rows ("random") and on most
    ("floor"), with the model's gates and the JAX tests' ones, f32 with
    slow gates, a ragged 500-token bf16 row, and a bf16 row of
    common-part inputs ("common": states C with a large common part that
    U = dH C cancels).  Each row: the route that ran
    (``ops.bwd_design_launches``), the floor's share of the rows
    (``ref.floor_share``), the carry share, the largest errors, a rerun's
    bit-equality, the kernel's time, its bound, autograd of the plain
    version's time; the slow bf16 rows also run a planted copy, which
    must fail (``fault_ok`` false): the reverse walk's carry dropped on
    the "random" row, the floor's branch ignored on the "floor" row, C
    rounded once in U (``ref.BWD_ROUND_FAULT``) on the "common" row.
    Every bf16 row must run on the tensor-core route ("mma.sync"), f32 on
    "fma"."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mlstm import ops as mo
    from repro_torch.kernels.mlstm import ref as mr
    from repro_torch.models import xlstm as xlstm_mod

    faults = {inputs: (name, _build.load(
        f"mlstm_bwd_{fault}_fault", _mlstm_bwd_fault_source(fault),
        mo._BWD_SIG)) for inputs, fault, name in (
            ("random", "carry", "carry dropped"),
            ("floor", "floor", "floor ignored"),
            ("common", "round", "C rounded once"))}
    ptxas = _ptxas("mlstm_bwd")
    _, hd = xlstm_mod.mlstm_dims(cfg)
    h, chunk = cfg.n_heads, 128
    cases = [("bfloat16", "slow", "random", length),
             ("bfloat16", "slow", "floor", length),
             ("bfloat16", "model", "random", length),
             ("bfloat16", "jax", "random", length),
             ("bfloat16", "slow", "random", length - 12),
             ("bfloat16", "slow", "common", length),
             ("float32", "slow", "random", length)]
    rows = []
    for dname, gates, inputs, ln in cases:
        dt_ = getattr(torch, dname)
        q, k, v, li, lf, dh = mr.grad_inputs(
            b, ln, h, hd, gates=gates, inputs=inputs, dtype=dt_, seed=25,
            device="cuda")
        binds = torch.empty((b, h, ln), device="cuda")
        mo.reset_launches()
        got = mo._launch_bwd(q, k, v, li, lf, dh, chunk, binds)
        route = [k_ for k_, n_ in mo.bwd_design_launches.items() if n_][0]
        again = mo._launch_bwd(q, k, v, li, lf, dh, chunk)
        ref = mr.mlstm_chunked_grads(q, k, v, li, lf, chunk, dh)
        wit = mr.mlstm_chunked_grads(q.float(), k.float(), v.float(), li,
                                     lf, chunk, dh.float())
        torch.cuda.synchronize()
        tol = SCAN_BWD_TOL[dname]
        oks, errs = _grads_check(torch, got, ref, tol)
        _, werrs = _grads_check(torch, got, wit, tol)
        bit_equal = all(torch.equal(u, w) for u, w in zip(got, again))
        share = mr.floor_share(q, k, v, li, lf, chunk)
        _, (cr, _, m_r) = mr.mlstm_chunked(q, k, v, li, lf, None, chunk)
        carry = _mlstm_carry_share(mr, q, k, v, li, lf, None, chunk, cr, m_r)
        ok = all(oks) and bit_equal \
            and abs(binds.mean().item() - share) < 0.01 \
            and (inputs != "floor" or share > 0.5) \
            and (gates != "slow" or inputs == "floor" or share < 0.5) \
            and route == mo.bwd_design(dt_)
        row = {"B": b, "L": ln, "H": h, "hd": hd, "chunk": chunk,
               "dtype": dname, "gates": gates, "inputs": inputs,
               "route": route, "floor_share": share, "kernel_floor_share":
               binds.mean().item(), "carry_share": carry,
               "ok_dq_dk_dv_dlogi_dlogf": oks,
               "max_abs_err_dq_dk_dv_dlogi_dlogf": errs,
               "witness_f32_max_abs_err": werrs,
               "max_abs_err": max(errs), "rtol": tol,
               "atol": "rtol x each gradient's largest magnitude",
               "bit_equal_rerun": bit_equal,
               "skipped": "the last chunk's own C, dC k and dC^T v; the "
                          "first chunk's U and own dC",
               "ptxas": ptxas}
        if gates == "slow" and dname == "bfloat16" and ln == length:
            name, lib = faults[inputs]
            with mock.patch.object(mo, "bwd_lib", lambda: lib):
                bad = mo._launch_bwd(q, k, v, li, lf, dh, chunk)
            foks, ferrs = _grads_check(torch, bad, ref, tol)
            row.update(fault=name, fault_ok=all(foks), fault_ok_each=foks,
                       fault_max_abs_err=ferrs)
            ok = ok and not all(foks)
            del bad
        ms = _time_ms(lambda: mo._launch_bwd(q, k, v, li, lf, dh, chunk),
                      iters=5)
        plain_ms = _time_ms(lambda: mr.mlstm_chunked_grads(
            q, k, v, li, lf, chunk, dh), iters=3, warmup=1)
        bound_ms, bound_by, flops, nbytes, f32_ms = _mlstm_bwd_bound(
            b, ln, h, hd, chunk, q.element_size(), dname)
        row.update(ok=ok, ms=ms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_f32_cores_ms=f32_ms,
                   tflops=flops / (ms * 1e-3) / 1e12,
                   gbytes_per_s=nbytes / ms * 1e-6)
        rows.append(row)
        print(f"kernel-check mlstm_bwd {json.dumps(row)}", flush=True)
        del got, again, ref, wit, q, k, v, li, lf, dh
    torch.cuda.empty_cache()
    mo.reset_launches()
    return rows


# Slice 18: the sLSTM scan kernels at xlstm-1.3b's width (d 2048, 4 heads
# of hd 512, r bf16, f32 state).  Tolerances, against the plain version
# on the same inputs: h (|h| <= 1) atol 1e-4; c and n rtol 1e-4 with
# atol 1e-4 times their largest magnitude; m atol 1e-4.  The kernel sums
# each 512-term recurrent product in another order than the plain
# einsum, and the recurrence carries that rounding along; an f64 witness
# of the plain path (rows up to 4096 steps) states how far f32 itself
# lies from exact: the kernel's h must lie no further from it than 4
# times the plain version's h, plus 1e-6.
SLSTM_TOL = {"h": 1e-4, "state": 1e-4, "m": 1e-4}
SLSTM_WITNESS_MAX_L = 4096
# (B, L, forget gates, initial state): training's rank batch, train_4k's
# micro-batch, prefill_32k's sequence, decode_32k's batch at one step
# from a state, a ragged length from a state
SLSTM_ROWS = [(2, 512, "model", False), (1, 4096, "slow", False),
              (1, 32768, "slow", False), (100, 1, "model", True),
              (1, 1000, "model", True)]
# the backward's: training's rank batch, train_4k's micro-batch, and a
# ragged row from a state with the final state's gradients
SLSTM_BWD_ROWS = [(2, 512, "model", False, False),
                  (1, 4096, "slow", False, False),
                  (2, 300, "slow", True, True)]


def _slstm_bound(b, length, d, hd, rsize, bwd=False, keep=False):
    """Least time of the sLSTM scan (forward, or with ``bwd`` its
    backward) on this input, from slstm/ops.py's ``work`` / ``bwd_work``:
    its operations (2 B L 4d hd, f32 FMAs) over the f32 CUDA-core peak
    against its bytes over HBM bandwidth."""
    from repro_torch.kernels.slstm import ops
    flops, nbytes = (ops.bwd_work(b, length, d, hd, rsize) if bwd
                     else ops.work(b, length, d, hd, rsize, keep))
    return (*_roof(flops, nbytes, "float32"), flops, nbytes)


def _slstm_fault_source(fault):
    """A copy of slstm.cu with the planted fault ``fault`` of
    ``ref.FWD_FAULTS``: "layout" (the recurrent term gate-major),
    "rescale" (the carried state not rescaled when m moves) or "exchange"
    (a consumer takes a ring word whatever its tag: h of a step before,
    or the ring's zeros, where the step is not out yet); or, "carry", a
    copy of slstm_bwd.cu whose carry dc skips its factor fi
    (``ref.BWD_CARRY_FAULT``)."""
    from repro_torch.kernels.slstm import ref as sr
    if fault == "carry":
        return _fault_source("slstm", "slstm_bwd.cu", sr.BWD_CARRY_FAULT,
                             "slstm_bwd_carry")
    return _fault_source("slstm", "slstm.cu", sr.FWD_FAULTS[fault],
                         f"slstm_{fault}")


def _slstm_f64(torch, sr, gx, r, bf, st, h):
    """The plain recurrence in float64 (the witness): h (B,L,d) f64."""
    r64, bf64 = r.double(), bf.double()
    s = {k: v.double() for k, v in st.items()}
    hs = []
    for t in range(gx.shape[1]):
        s = sr.slstm_cell(gx[:, t].double(), s, r64, bf64, h)
        hs.append(s["h"])
    return torch.stack(hs, dim=1)


def _slstm_ptxas(name):
    from repro_torch.kernels import _build
    return [ln.strip() for ln in _build.build_logs.get(name, "").splitlines()
            if "registers" in ln or "spill" in ln]


def _slstm_state_ok(torch, fin, ref):
    """(ok, max abs error) of each final state leaf against the plain
    version's, at SLSTM_TOL."""
    oks, errs = {}, {}
    for k in ("c", "n", "h", "m"):
        scale = max(1.0, ref[k].abs().max().item())
        atol = SLSTM_TOL["m"] if k == "m" else (
            SLSTM_TOL["h"] if k == "h" else SLSTM_TOL["state"] * scale)
        rtol = 0.0 if k in ("h", "m") else SLSTM_TOL["state"]
        oks[k] = bool(torch.isfinite(fin[k]).all()) and torch.allclose(
            fin[k], ref[k], atol=atol, rtol=rtol)
        errs[k] = (fin[k] - ref[k]).abs().max().item()
    return oks, errs


def check_slstm(torch, cfg):
    """The slstm forward kernel against its plain version (the token
    loop, ``ref.slstm_scan``) at xlstm-1.3b's width on SLSTM_ROWS
    (``ref.slstm_inputs``: gx N(0, 1), r bf16 with a scale per head, so a
    layout that mixes heads shows; "slow" forget gates sigma ~ 0.999, a
    carry over thousands of steps).  h is compared by rows
    (``_close_by_rows``), the final state leaf by leaf, at SLSTM_TOL;
    rows up to SLSTM_WITNESS_MAX_L steps also against an f64 witness.
    The plain version runs once a row (at L 32768 some tens of seconds).
    Each row: the kernel's time, per step, its bound and per step, the
    plain version's time, library none (no PyTorch call computes this
    recurrence; ``nn.LSTM`` is another function), the grid (``ops.plan``:
    blocks, rows a tile, R's slots, registers and spills), the step-tagged
    exchange's own cost a step at the row's rows a tile (``sl_exchange``
    on the same grid, 4096 steps; the kernel's floor a step) and, beside
    it, the grid barrier's (``sl_barrier``, what PR 28's design paid).
    Then a ``split`` row: the fit us_per_step = fixed + per_row x B
    through the 1 x 4096 and 2 x 512 rows, and both exchange forms
    (``ops.exchange_us``: "tag", the kernel's, and "flag", a release flag
    a block before one read) at 1 and 4 rows.  Last, the three planted
    copies of ``ref.FWD_FAULTS`` on the 2 x 512 row with slow gates from a
    state, their outputs starting as NaN: each must fail (``fault_ok``
    false)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.slstm import ops as so
    from repro_torch.kernels.slstm import ref as sr

    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    lib = so.lib()
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    barrier, exchange = {}, {}
    for b, length, gates, with_state in SLSTM_ROWS:
        gx, r, bf, st = sr.slstm_inputs(b, length, d, h, seed=length + b,
                                        gates=gates, state=with_state,
                                        rdtype=torch.bfloat16,
                                        device="cuda")
        y, fin, _ = so._launch(gx, r, bf, st, keep=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yr, fr = sr.slstm_scan(gx, r, bf, st, h)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        ok_h, err_h = _close_by_rows(torch, y, yr, SLSTM_TOL["h"], 0.0)
        oks, errs = _slstm_state_ok(torch, fin, fr)
        witness = None
        if length <= SLSTM_WITNESS_MAX_L:
            yw = _slstm_f64(torch, sr, gx, r, bf, st, h)
            k_w = (y.double() - yw).abs().max().item()
            p_w = (yr.double() - yw).abs().max().item()
            witness = {"kernel_vs_f64": k_w, "plain_vs_f64": p_w,
                       "ok": k_w <= 4 * p_w + 1e-6}
            del yw
        del yr, fr
        iters = max(1, min(20, 4096 // length))
        ms = _time_ms(lambda: so._launch(gx, r, bf, st, keep=False),
                      iters=iters, warmup=1)
        plan = so.plan(lib, b, d, h, r.dtype)
        if plan["blocks"] not in barrier:
            steps = 4096
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            err = lib.sl_barrier(plan["blocks"], so.THREADS, steps, stream)
            ev[1].record()
            torch.cuda.synchronize()
            assert err == 0, err
            barrier[plan["blocks"]] = ev[0].elapsed_time(ev[1]) / steps * 1e3
        if plan["bt"] not in exchange:
            exchange[plan["bt"]] = so.exchange_us(
                lib, plan["blocks"], plan["jb"], d, plan["bt"], "tag")
        bound_ms, bound_by, flops, nbytes = _slstm_bound(b, length, d, hd, 2)
        ok = ok_h and all(oks.values()) and (witness is None
                                             or witness["ok"])
        row = {"B": b, "L": length, "d": d, "H": h, "hd": hd, "gates": gates,
               "state": with_state, "r_dtype": "bfloat16",
               "max_abs_err": err_h, "state_max_abs_err": errs,
               "ok_h": ok_h, "ok_state": oks, "witness_f64": witness,
               "tol": SLSTM_TOL, "ok": ok, "ms": ms,
               "us_per_step": ms * 1e3 / length, "plain_ms": plain_ms,
               "plain_runs": 1, "library_ms": None,
               "library": "none: no PyTorch call computes the sLSTM scan",
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_us_per_step": bound_ms * 1e3 / length,
               "exchange_us_per_step": exchange[plan["bt"]],
               "barrier_us_per_step": barrier[plan["blocks"]],
               "grid": plan, "threads": so.THREADS,
               "gflops": flops / (ms * 1e-3) / 1e9,
               "gbytes_per_s": nbytes / ms * 1e-6,
               "ptxas": _slstm_ptxas("slstm")}
        rows.append(row)
        print(f"kernel-check slstm {json.dumps(row)}", flush=True)
        del gx, r, bf, st, y, fin
        torch.cuda.empty_cache()
    per = {(r_["B"], r_["L"]): r_["us_per_step"] for r_ in rows}
    per_row = per[(2, 512)] - per[(1, 4096)]
    plan = so.plan(lib, 1, d, h, torch.bfloat16)
    row = {"split": {"fixed_us_per_step": per[(1, 4096)] - per_row,
                     "per_row_us_per_step": per_row,
                     "fit": "us_per_step = fixed + per_row x B through "
                            "1 x 4096 and 2 x 512"},
           "exchange_us_per_step": {
               form: {n: so.exchange_us(lib, plan["blocks"], plan["jb"], d,
                                        n, form) for n in (1, 4)}
               for form in so.EXCHANGE_FORMS},
           "kernel_form": "tag", "ok": True}
    rows.append(row)
    print(f"kernel-check slstm {json.dumps(row)}", flush=True)
    # the planted copies, each on one row that a fault must fail
    gx, r, bf, st = sr.slstm_inputs(2, 512, d, h, seed=3, gates="slow",
                                    state=True, rdtype=torch.bfloat16,
                                    device="cuda")
    yr, fr = sr.slstm_scan(gx, r, bf, st, h)
    for fault in sorted(sr.FWD_FAULTS):
        flib = _build.load(f"slstm_{fault}_fault",
                           _slstm_fault_source(fault), so._SIG)
        err, y, fin, _ = so.call(flib, gx, r, bf, st, False, stream,
                                 fill=float("nan"))
        torch.cuda.synchronize()
        assert err == 0, err
        fok, ferr = _close_by_rows(torch, y, yr, SLSTM_TOL["h"], 0.0)
        row = {"B": 2, "L": 512, "gates": "slow", "state": True,
               "fault": fault, "fault_ok": fok, "fault_max_abs_err": ferr,
               "fault_finite": bool(torch.isfinite(y).all()),
               "ok": not fok}
        rows.append(row)
        print(f"kernel-check slstm {json.dumps(row)}", flush=True)
    del gx, r, bf, st, yr, fr
    so.reset_launches()
    torch.cuda.empty_cache()
    return rows


def check_slstm_bwd(torch, cfg):
    """The slstm backward kernel (through the forward kernel's histories)
    and the wrapper's dr against autograd of the plain version
    (``ref.slstm_grads``, r widened to f32 so that dr is compared before
    its rounding to bf16) on SLSTM_BWD_ROWS, under loss sum(y dy) (+ the
    final state's leaves weighted, on the row that gives them): dgx, dbf,
    the initial state's four gradients and dr, each within rtol 1e-4 and
    atol 1e-4 times its largest magnitude.  The kernel carries the
    stabiliser's terms as autograd does (slstm_bwd.cu).  Each row: the
    kernel's time (the backward launch alone), per step, its bound, the
    plain version's time (autograd of the loop, forward and backward,
    once), library none, a rerun's bit-equality.  Last, the planted copy
    of ``ref.BWD_CARRY_FAULT`` on the row from a state: its dgx must fail
    (``fault_ok`` false)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.slstm import ops as so
    from repro_torch.kernels.slstm import ref as sr

    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    rows = []
    for b, length, gates, with_state, final in SLSTM_BWD_ROWS:
        gx, r, bf, st = sr.slstm_inputs(b, length, d, h, seed=length + b + 1,
                                        gates=gates, state=with_state,
                                        rdtype=torch.bfloat16,
                                        device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(length)
        dy = torch.randn((b, length, d), generator=gen, device="cuda")
        dfin = {k: (torch.randn((b, d), generator=gen, device="cuda")
                    if final else None) for k in ("c", "n", "h", "m")}
        y, fin, hist = so._launch(gx, r, bf, st, keep=True)
        dg, dbf, dst = so._launch_bwd(r, bf, st, hist, dy, dfin)
        again = so._launch_bwd(r, bf, st, hist, dy, dfin)
        h_before = torch.cat([st["h"][:, None], y[:, :-1]], dim=1)
        dr = so.recurrent_grad(h_before, dg, h)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = sr.slstm_grads(gx, r.float(), bf, st, h, dy, dfin)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = {"dgx": dg, "dbf": dbf, "dr": dr,
               **{f"d{k}": dst[k] for k in ("c", "n", "h", "m")}}
        want = {"dgx": ref["gx"], "dbf": ref["bf"], "dr": ref["r"],
                **{f"d{k}": ref["state"][k] for k in ("c", "n", "h", "m")}}
        oks, errs = {}, {}
        for name in got:
            scale = max(1.0, want[name].abs().max().item())
            oks[name] = bool(torch.isfinite(got[name]).all()) and \
                torch.allclose(got[name], want[name].float(),
                               atol=1e-4 * scale, rtol=1e-4)
            errs[name] = (got[name] - want[name]).abs().max().item()
        bit_equal = all(torch.equal(u, w) for u, w in zip(
            (dg, dbf, *dst.values()), (again[0], again[1],
                                       *again[2].values())))
        ms = _time_ms(lambda: so._launch_bwd(r, bf, st, hist, dy, dfin),
                      iters=max(1, min(10, 4096 // length)), warmup=1)
        bound_ms, bound_by, flops, nbytes = _slstm_bound(b, length, d, hd, 2,
                                                         bwd=True)
        plan = so.plan(so.bwd_lib(), b, d, h, r.dtype, bwd=True)
        row = {"B": b, "L": length, "d": d, "H": h, "hd": hd,
               "gates": gates, "state": with_state, "final_grads": final,
               "ok_each": oks, "max_abs_err_each": errs,
               "max_abs_err": max(errs.values()),
               "tol": "rtol 1e-4, atol 1e-4 x each gradient's largest "
                      "magnitude", "bit_equal_rerun": bit_equal,
               "ok": all(oks.values()) and bit_equal, "ms": ms,
               "us_per_step": ms * 1e3 / length, "plain_ms": plain_ms,
               "plain": "autograd of ref.slstm_scan, forward and "
                        "backward, once", "library_ms": None,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_us_per_step": bound_ms * 1e3 / length,
               "grid": plan, "gflops": flops / (ms * 1e-3) / 1e9,
               "ptxas": _slstm_ptxas("slstm_bwd")}
        rows.append(row)
        print(f"kernel-check slstm_bwd {json.dumps(row)}", flush=True)
        del gx, r, bf, st, dy, y, fin, hist, dg, dbf, dst, again, ref, dr
        torch.cuda.empty_cache()
    # the planted copy (``ref.BWD_CARRY_FAULT``: dc passed on without its
    # factor fi) on the row from a state with the final state's gradients,
    # its outputs starting as NaN: dgx must fail
    b, length, gates, with_state, final = SLSTM_BWD_ROWS[2]
    gx, r, bf, st = sr.slstm_inputs(b, length, d, h, seed=length + b + 1,
                                    gates=gates, state=with_state,
                                    rdtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(length)
    dy = torch.randn((b, length, d), generator=gen, device="cuda")
    dfin = {k: torch.randn((b, d), generator=gen, device="cuda")
            for k in ("c", "n", "h", "m")}
    _, _, hist = so._launch(gx, r, bf, st, keep=True)
    ref = sr.slstm_grads(gx, r.float(), bf, st, h, dy, dfin)
    flib = _build.load("slstm_bwd_carry_fault",
                       _slstm_fault_source("carry"), so._BWD_SIG)
    err, dg, _, _ = so.call_bwd(flib, r, bf, st, hist, dy, dfin,
                                torch.cuda.current_stream().cuda_stream,
                                fill=float("nan"))
    torch.cuda.synchronize()
    assert err == 0, err
    scale = max(1.0, ref["gx"].abs().max().item())
    fok = torch.allclose(dg, ref["gx"], atol=1e-4 * scale, rtol=1e-4)
    row = {"B": b, "L": length, "gates": gates, "state": with_state,
           "fault": "carry", "fault_ok": fok,
           "fault_max_abs_err": (dg - ref["gx"]).abs().max().item(),
           "ok": not fok}
    rows.append(row)
    print(f"kernel-check slstm_bwd {json.dumps(row)}", flush=True)
    del gx, r, bf, st, dy, hist, ref, dg
    torch.cuda.empty_cache()
    so.reset_launches()
    return rows


def serve_family(torch, cfg, params, tag, counters, reduced=None,
                 extras=None):
    """The serving path of one family at full width and depth: 8 Poisson
    requests (prompts 256-1024 tokens, cut to whole 64-token chunks for
    a hybrid config, whose prefill runs at the exact length; an xLSTM
    config's prefill runs at the exact, ragged length; 16-32 new
    tokens) through ``ContinuousServeLoop`` (8 slots, max_len 2048), then
    one ``ServeLoop`` batch of 4 x 512.  Every kernel count is set to 0
    just before and read just after; each must equal what the path
    implies: per prefill one launch per attention block (flash), per
    Mamba block (mamba_scan) and per mLSTM block (mlstm), per prefill and
    decode step one per MoE block (moe_gmm); an ENCDEC block's causal
    self-attention counts as an attention block, its cross-attention and
    the audio encoder do not, nor does a CROSS_ATTN block (plain
    products); per prefill and decode step one per sLSTM block (slstm:
    the scan kernel, one launch a layer at any length).  ``reduced``
    names a cut of the config, printed on the line; ``extras`` as
    warm_up's."""
    from repro_torch.configs.base import ATTN, ENCDEC, MAMBA, MLSTM, MOE, \
        SHARED_ATTN, SLSTM
    from repro_torch.runtime.admission import request_stream

    reqs = request_stream(8, 0.25, seed=2, regime="poisson",
                          vocab=cfg.vocab, prompt_lens=(256, 1024),
                          max_new=(16, 32))
    if MAMBA in cfg.period():
        for r in reqs:
            r.prompt = r.prompt[:len(r.prompt) // cfg.ssm_chunk
                                * cfg.ssm_chunk]
    freqs = request_stream(4, 0.25, seed=3, regime="poisson",
                           vocab=cfg.vocab, prompt_lens=(512, 512),
                           max_new=(16, 32))
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    one, batch = extras or (None, None)
    cont, admitted = _drive_continuous(torch, cfg, params, reqs,
                                       extras_fn=one)
    fixed = _drive_fixed(torch, cfg, params, freqs, extras_fn=batch)
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}
    kinds = cfg.period() * cfg.n_periods()
    n_moe = kinds.count(MOE)
    n_attn = sum(kinds.count(k) for k in (ATTN, SHARED_ATTN, MOE, ENCDEC))
    prefills = admitted + 1
    steps = cont["steps"] + fixed["steps"]
    expect = dict.fromkeys(counters, 0)
    expect["flash_attention"] = n_attn * prefills
    expect["moe_gmm"] = n_moe * (prefills + steps)
    expect["mamba_scan"] = kinds.count(MAMBA) * prefills
    expect["mlstm"] = kinds.count(MLSTM) * prefills
    expect["slstm"] = kinds.count(SLSTM) * (prefills + steps)
    res = {"arch": cfg.name, "n_layers": cfg.n_layers, "reduced": reduced,
           "continuous": cont, "fixed": fixed,
           "prefills": prefills, "decode_steps": steps,
           "launches": launches, "expected_launches": expect}
    print(f"serve-{tag} {json.dumps(res)}", flush=True)
    assert launches == expect, (launches, expect)
    return reqs, launches


def draw_gates(torch, cfg, params, seed=5):
    """Give every CROSS_ATTN block of ``params`` gates drawn from N(0, 1)
    (f32, one per layer).  At init they are 0, and tanh(0) = 0 makes the
    block the identity, through which no check sees the cross-attention,
    the image K/V cache or a lost image."""
    import numpy as np

    from repro_torch.configs.base import CROSS_ATTN
    rng = np.random.default_rng(seed)
    for blk, kind in zip(params["blocks"], cfg.period()):
        if kind == CROSS_ATTN:
            for g in ("gate_attn", "gate_mlp"):
                blk[g] = torch.as_tensor(
                    rng.normal(size=tuple(blk[g].shape)).astype(np.float32),
                    device=blk[g].device)


# phi3.5-moe-42b-a6.6b at full width, cut in depth: 8 of its 32 layers
# are 10,665,136,128 params (21.3 GB in bf16); all 32 are 41,872,527,360
# (83.7 GB), more than the card's 80 GB.
PHI_LAYERS = 8
# xlstm-1.3b at full width, cut in depth for the script's time limit: its
# sLSTM token loop made the family 156-189 s of the phases at full depth
# (slice 18 replaced the loop by the slstm scan kernels).
# It trains at 2 of its 6 periods (1 sLSTM + 7 mLSTM each), 16 of 48
# layers: at 8, step 0's gradient check is a draw for bf16 at that
# depth, not a test of the kernels.  Over 12 draws (weight seeds 0-5,
# data steps 0-1) it passes 5 with the mLSTM forward's f32 operands in
# three bf16 parts and 5 with two, and 7 for the plain path with its h
# one ulp off on 0.05% of elements at random; seed 0, this script's,
# fails at 8 and passes at 16 (attribute_xlstm.py --sweep; PERF.md §6).
# It serves at 1 period, 8 layers (since slice 16), where no gradient is
# checked.
XLSTM_LAYERS = 16
XLSTM_SERVE_LAYERS = 8
_TIME_CUT = "for the script's time limit"
# (arch, line tag, layers or None, the cut or None)
FAMILIES = [
    ("granite-moe-1b-a400m", "moe", None, None),
    ("phi3.5-moe-42b-a6.6b", "moe_phi", PHI_LAYERS,
     f"depth {PHI_LAYERS} of 32 layers: 10,665,136,128 params (21.3 GB "
     "bf16); all 32 are 83.7 GB, over the card's 80 GB"),
    ("zamba2-2.7b", "hybrid", None, None),
    ("xlstm-1.3b", "ssm", XLSTM_SERVE_LAYERS,
     f"depth {XLSTM_SERVE_LAYERS} of 48 layers (1 of 6 periods), "
     f"{_TIME_CUT}"),
    ("whisper-small", "audio", None, None),
    ("llama-3.2-vision-11b", "vlm", None, None)]


def families(torch, counters, phase_time):
    """Phase 8: serve full-width granite-moe-1b-a400m, phi3.5-moe-42b-a6.6b,
    zamba2-2.7b, xlstm-1.3b, whisper-small and llama-3.2-vision-11b,
    phi3.5-moe and xlstm cut in depth as FAMILIES says, in bf16
    (random weights from a seed; the vision model's cross-attention
    gates drawn, ``draw_gates``): first use of every serve shape, the
    serving drive, the prefill check and a profile, for each.  The audio
    and VLM requests carry the serve CLI's extras (encoder frames of
    (1, 1500, 768), image tokens of (1, 1601, 4096), drawn from
    ``default_rng([0, 5, rid])``).  ``phase_time`` marks each family's
    end."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import _extras_fns
    from repro_torch.models import transformer as tf

    total = dict.fromkeys(counters, 0)
    for arch, tag, layers, reduced in FAMILIES:
        cfg = get_config(arch)
        if layers:
            cfg = cfg.with_(n_layers=layers)
        gen = torch.Generator(device="cuda").manual_seed(0)
        extras = _extras_fns(cfg, 0, "cuda")     # (None, None) elsewhere
        with torch.no_grad():
            params = tf.init_params(gen, cfg, device="cuda")
            draw_gates(torch, cfg, params)
            warm_up(torch, cfg, params, MAX_LEN, extras=extras)
            reqs, launches = serve_family(torch, cfg, params, tag, counters,
                                          reduced=reduced, extras=extras)
            check_prefill(torch, cfg, params, reqs, MAX_LEN,
                          extras_fn=extras[0])
            profile(torch, cfg, params, tag=f"{tag}_", extras=extras)
        for name in total:
            total[name] += launches[name]
        del params
        torch.cuda.empty_cache()
        phase_time(f"family-{tag}")
    return total


# Slice 11: the audio, VLM and MoE families train.  (arch, line tag,
# layers or None, virtual ranks, global batch, seq_len, steps, peak
# learning rate, the cut or None.)  whisper-small whole at its published
# decoder context (448) with (8, 1500, 768) frames; granite-moe-1b-a400m
# whole at 8 x 1024 over 2 ranks (a rank's 4 x 1024 tokens route as 8
# groups x capacity 160: M 1280 for moe_gmm); llama-3.2-vision-11b cut to
# 10 of its 40 layers (2 of its 8 periods of 4 ATTN + 1 CROSS_ATTN):
# 3,231,797,252 params, a 32.3 GB train state at 10 bytes a parameter,
# where all 40 layers would be 97.8 GB; 2 ranks of 1 x 1024 (its global
# batch of 2 allows no more).  Not 5: there the last block's gate_mlp
# gradient fails step 0's check on the kernel path (0.32 of the f32
# witness against the plain path's 0.014, PERF.md PR 27).
VISION_TRAIN_LAYERS = 10
HYBRID_TRAIN_LAYERS = 12
# The learning rates warm up over half the steps.  At the llama phase's
# 1e-3 (warm-up 1 step) whisper-small's loss rose from its second step
# on the card, at 3e-4 llama-3.2-vision-11b's did (12.1 to 19.8 in 4
# steps), and at 1e-4 it fell with a spike (12.1, ..., 17.4, ..., 9.9 in
# 8); at these rates each fell.  Whether the loss falls depends on the
# rate; ``family_grad_check`` holds the gradient itself, whatever the
# rate.
#
# Slice 13: the hybrid and xLSTM families train, through the mamba_scan and
# mlstm backward kernels.  zamba2-2.7b at HYBRID_TRAIN_LAYERS of its 54
# (10 Mamba2 + 2 uses of the shared attention; whole until slice 17 cut
# it for the script's time limit) at 2 ranks of 2 x 1024; xlstm-1.3b at
# XLSTM_LAYERS of its 48 layers, at 2 ranks of 2 x 512 (its sLSTM
# through the slstm scan kernels since slice 18: the forward twice under
# remat, the backward once).
TRAIN_FAMILIES = [
    ("whisper-small", "audio", None, 4, 8, 448, 6, 1e-4, None),
    ("granite-moe-1b-a400m", "moe", None, 2, 8, 1024, 6, 3e-4, None),
    ("llama-3.2-vision-11b", "vlm", VISION_TRAIN_LAYERS, 2, 2, 1024, 8,
     5e-5, f"depth {VISION_TRAIN_LAYERS} of 40 layers: 3,231,797,252 "
     "params (32.3 GB of train state); all 40 are 97.8 GB, over the "
     "card's 80 GB"),
    ("zamba2-2.7b", "hybrid", HYBRID_TRAIN_LAYERS, 2, 4, 1024, 6, 1e-4,
     f"depth {HYBRID_TRAIN_LAYERS} of 54 layers (2 of 9 periods), for the "
     "script's time limit"),
    ("xlstm-1.3b", "ssm", XLSTM_LAYERS, 2, 4, 512, 4, 1e-4,
     f"depth {XLSTM_LAYERS} of 48 layers (2 of 6 periods), for the "
     "script's time limit; not 8, where step 0's gradient check cannot "
     "separate the kernel path from bf16 noise")]


def _pinned_routes(torch, routes):
    """A wrapper of ``moe._route``.  With ``routes`` empty it records each
    call's expert choice idx (G, S, k), in call order; else it replays
    them in that order, with the gates and the aux loss from this call's
    own router probabilities (as ``moe._route`` forms them), so that
    paths whose rounding differs route alike (no flip)."""
    from repro_torch.models import moe as moe_mod
    orig = moe_mod._route
    replay = iter(list(routes))
    record = not routes

    def route(router_w, x, cfg):
        if record:
            gates, idx, aux = orig(router_w, x, cfg)
            routes.append(idx)
            return gates, idx, aux
        idx = next(replay)
        probs = torch.softmax(torch.einsum("gsd,de->gse", x.float(),
                                           router_w), dim=-1)
        gates = probs.gather(-1, idx)
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        top1 = torch.nn.functional.one_hot(idx[..., 0], cfg.n_experts)
        aux = cfg.n_experts * torch.sum(probs.mean(dim=(0, 1))
                                        * top1.float().mean(dim=(0, 1)))
        return gates, idx, aux
    return mock.patch.object(moe_mod, "_route", route)


def family_grad_check(torch, cfg, dcfg, ranks):
    """Step 0 of a train family, independent of the learning rate: rank
    0's loss and gradient, from the weights ``FaabricTrainRuntime`` starts
    from (seed 0, the vision gates drawn) on its first batch, through the
    kernel path and through the plain paths, both bf16, each held against
    an f32 witness of the same weights and batch on the plain paths.  The
    MoE layers route as the kernel path did (``_pinned_routes``), so a
    flip does not separate paths that are both right.  Passes when the
    kernel path's loss is within TRAIN_TOL of the witness's; its whole
    gradient no further from the witness than 1.25 times the plain
    path's, and within TRAIN_TOL wherever the plain path's is (bf16
    drifts further at depth: granite's 24 MoE layers put the plain path
    itself at 0.22 on the card); and every leaf within TRAIN_TOL["grad"]
    of the witness's or no further than 1.25 times the plain path's leaf
    (a wrong backward puts some leaf near 1).  A leaf that fails this
    where the plain path's own leaf is beyond TRAIN_TOL["grad"] of the
    witness is one where bf16 drifts on both paths (zamba2's a_log at
    full depth: 1.0-1.13 on the plain path; xlstm's input-gate biases),
    and the bf16 comparison cannot tell a wrong backward from the drift:
    then the kernel path runs again in f32, its loss and every one of its
    leaves must be within TRAIN_TOL of the witness, and it judges those
    leaves.  The kernel path must launch the backward kernel of each of
    the family's kernels (flash for an attention layer, moe_gmm,
    mamba_scan, mlstm, slstm), the plain paths no kernel."""
    from repro_torch.configs.base import (ATTN, ENCDEC, MAMBA, MLSTM, MOE,
                                          SHARED_ATTN, SLSTM)
    from repro_torch.data import pipeline as dp
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mlstm import ops as ml_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.slstm import ops as sl_ops
    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.train_loop import family_batch_fn
    from repro_torch.weights import tree_leaves_with_path, tree_map

    kinds = cfg.period()
    # each kernel's module, and whether the family's layers run it
    mods = {fa_ops: any(k in kinds for k in (ATTN, SHARED_ATTN, MOE,
                                             ENCDEC)),
            gmm_ops: MOE in kinds, scan_ops: MAMBA in kinds,
            ml_ops: MLSTM in kinds, sl_ops: SLSTM in kinds}

    def counts():
        return {m: (m.launches, m.bwd_launches) for m in mods}
    grad_fn = model_mod.make_grad_fn(cfg)
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, device="cuda")
    draw_gates(torch, cfg, params)
    batch = {k: v.cuda() for k, v in dp.shard_slice(
        family_batch_fn(cfg)(dcfg, 0), 0, ranks).items()}
    routes = []

    def run(p, b, plain):
        before = counts()
        with _pinned_routes(torch, routes):
            if plain:
                with _plain_paths():
                    (loss, _), g = grad_fn(p, b)
                assert counts() == before, "a plain path launched a kernel"
            else:
                (loss, _), g = grad_fn(p, b)
                after = counts()
                assert all(after[m][1] > before[m][1]
                           for m, used in mods.items() if used), \
                    "a backward kernel of the family did not launch"
        torch.cuda.synchronize()
        return float(loss), [t for _, t in tree_leaves_with_path(g)]

    lk, gk = run(params, batch, False)
    n_routes = len(routes)
    lp, gp = run(params, batch, True)
    params32 = tree_map(lambda t: t.float(), params)
    batch32 = {k: (v if k in ("tokens", "labels") else v.float())
               for k, v in batch.items()}
    del params
    lw, gw = run(params32, batch32, True)
    names = [n for n, _ in tree_leaves_with_path(params32)]
    sq = {"k": 0.0, "p": 0.0, "w": 0.0}
    worst = {"leaf": None, "kernel_vs_f32": 0.0, "plain_vs_f32": None}
    bad = []
    for name, a, b, w in zip(names, gk, gp, gw):
        ek = (a.float() - w).norm().item()
        ep = (b.float() - w).norm().item()
        nw = w.norm().item()
        sq["k"] += ek * ek
        sq["p"] += ep * ep
        sq["w"] += nw * nw
        rk, rp = (ek / nw, ep / nw) if nw else (ek, ep)
        if rk > worst["kernel_vs_f32"]:
            worst = {"leaf": name, "kernel_vs_f32": rk, "plain_vs_f32": rp}
        if not (math.isfinite(rk) and (rk <= TRAIN_TOL["grad"]
                                       or rk <= 1.25 * rp)):
            bad.append((name, rk, rp))
    # the failed leaves where bf16 drifts on the plain path too: judged by
    # the kernel path in f32, every leaf of which must then pass
    drifted = [n for n, _, rp in bad if rp > TRAIN_TOL["grad"]]
    k32 = None
    if drifted:
        lk32, gk32 = run(params32, batch32, False)
        r32 = []
        for a, w in zip(gk32, gw):
            nw = w.norm().item()
            e = (a - w).norm().item()
            r32.append(e / nw if nw else e)
        i32 = max(range(len(r32)), key=r32.__getitem__)
        k32 = {"loss_vs_f32": abs(lk32 - lw) / abs(lw),
               "worst_leaf": names[i32], "worst": r32[i32],
               "leaves_failed": [(n, r) for n, r in zip(names, r32)
                                 if not r <= TRAIN_TOL["grad"]]}
        bad = [row for row in bad if row[0] not in drifted]
        del gk32
    del params32, batch32, batch, gk, gp, gw
    torch.cuda.empty_cache()
    res = {"arch": cfg.name,
           "rank_batch": [dcfg.global_batch // ranks, dcfg.seq_len],
           "loss_kernel": lk, "loss_plain": lp, "loss_f32": lw,
           "loss_kernel_vs_f32": abs(lk - lw) / abs(lw),
           "loss_plain_vs_f32": abs(lp - lw) / abs(lw),
           "grad_kernel_vs_f32": math.sqrt(sq["k"] / sq["w"]),
           "grad_plain_vs_f32": math.sqrt(sq["p"] / sq["w"]),
           "grad_norm_f32": math.sqrt(sq["w"]), "leaves": len(names),
           "worst_leaf": worst, "leaves_failed": bad,
           "drifted_leaves": drifted, "kernel_f32": k32,
           "pinned_routes": n_routes, "tol": TRAIN_TOL}
    res["ratio"] = res["grad_kernel_vs_f32"] / res["grad_plain_vs_f32"]
    print(f"train-family-grad {json.dumps(res)}", flush=True)
    assert res["loss_kernel_vs_f32"] <= TRAIN_TOL["loss"], res
    assert res["ratio"] <= 1.25, res
    if res["grad_plain_vs_f32"] <= TRAIN_TOL["grad"]:
        assert res["grad_kernel_vs_f32"] <= TRAIN_TOL["grad"], res
    assert not bad, res
    if k32 is not None:
        assert k32["loss_vs_f32"] <= TRAIN_TOL["loss"], res
        assert not k32["leaves_failed"], res
    return res


def predicted_step_calls(cfg, batch, seq):
    """Kernel calls of one rank's training step by the analysis
    (``launch.dryrun.measure``: the step traced on the meta device at 1
    and 2 periods, the difference method), at no more than 32 tokens
    for the xLSTM family (its calls do not depend on the length)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as dr
    s = min(seq, 32) if cfg.family == "ssm" else seq
    m = dr.measure(cfg, ShapeConfig("rank", s, batch, "train"), batch)
    return {k: round(v["calls"]) for k, v in m["kernels"].items()}


def train_families(torch, counters, phase_time):
    """Phase 9: ``FaabricTrainRuntime`` trains each of TRAIN_FAMILIES from
    seeded random weights (the vision model's cross-attention gates drawn,
    ``draw_gates``), hierarchical sync, remat on, the batches' extras
    (frames, image tokens) drawn inside ``make_batch``.  Every kernel
    count is set to 0 just before the run and read just after; each must
    equal what the code implies: per step and rank, a flash forward per
    causal self-attention layer (ATTN, MOE and ENCDEC blocks; the encoder
    and the cross-attention are plain products) twice (the forward and
    remat's recompute) and a flash backward once; a moe_gmm forward per
    MOE layer twice and its backward once; the same for mamba_scan per
    MAMBA layer, mlstm per MLSTM layer and slstm per SLSTM layer.  Before
    the run,
    ``family_grad_check`` holds step 0's loss and gradient against the
    plain paths and an f32 witness, whatever the learning rate; after
    it, the loss must have fallen.  The runtime saves the state before
    step 0, as every run does.  Every moe_gmm backward call must go
    through the wgmma design, and every mamba_scan and mlstm backward call
    through the tensor-core route, "mma.sync" (each ``ops``'s
    ``bwd_design_launches``).  After the
    run, one more step of the MoE family's (granite's) runtime, warm, is
    profiled (``profile_phase``: device time by kernel kind, idle
    share)."""
    from repro_torch.configs.base import (ATTN, ENCDEC, MAMBA, MLSTM, MOE,
                                          SHARED_ATTN, SLSTM)
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mlstm import ops as ml_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.models.model import count_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import (FaabricTrainRuntime,
                                                RuntimeConfig,
                                                extra_batch_specs,
                                                family_batch_fn)

    total = dict.fromkeys(counters, 0)
    routed = {"moe_gmm_bwd": gmm_ops, "mamba_scan_bwd": scan_ops,
              "mlstm_bwd": ml_ops}
    for name, mod in routed.items():
        total[f"{name}_by_design"] = dict.fromkeys(mod.BWD_DESIGNS, 0)
    for arch, tag, layers, ranks, gb, seq, steps, lr, cut in TRAIN_FAMILIES:
        cfg = get_config(arch)
        if layers:
            cfg = cfg.with_(n_layers=layers)
        n_params = count_params(cfg)
        state_bytes = state_nbytes(cfg)
        ckpt_dir = os.path.join(CKPT_ROOT, f"train-{tag}")
        _disk_check(state_bytes)
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb)
        step0 = family_grad_check(torch, cfg, dcfg, ranks)
        ocfg = AdamWConfig(lr=lr, warmup_steps=steps // 2,
                           total_steps=steps)
        rt = RuntimeConfig(total_steps=steps, checkpoint_every=0,
                           ckpt_dir=ckpt_dir)
        runtime = FaabricTrainRuntime(cfg, ocfg, dcfg, rt, ranks=ranks,
                                      device="cuda")
        state = runtime.init_state(seed=0)
        draw_gates(torch, cfg, state["params"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        for mod in routed.values():
            mod.reset_launches()
        t0 = time.perf_counter()
        state, out = runtime.run(state=state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: getattr(mod, attr)
                    for name, (mod, attr) in counters.items()}
        designs = {name: dict(mod.bwd_design_launches)
                   for name, mod in routed.items()}
        kinds = cfg.period() * cfg.n_periods()
        n_attn = sum(kinds.count(k) for k in (ATTN, SHARED_ATTN, MOE, ENCDEC))
        n_moe = kinds.count(MOE)
        n_mamba, n_mlstm = kinds.count(MAMBA), kinds.count(MLSTM)
        n_slstm = kinds.count(SLSTM)
        fwd = 2 if cfg.remat else 1
        per = ranks * steps
        expect = dict.fromkeys(counters, 0)
        expect.update(flash_attention=fwd * n_attn * per,
                      flash_attention_bwd=n_attn * per,
                      moe_gmm=fwd * n_moe * per, moe_gmm_bwd=n_moe * per,
                      mamba_scan=fwd * n_mamba * per,
                      mamba_scan_bwd=n_mamba * per,
                      mlstm=fwd * n_mlstm * per, mlstm_bwd=n_mlstm * per,
                      slstm=fwd * n_slstm * per, slstm_bwd=n_slstm * per)
        predicted = dict.fromkeys(counters, 0)
        predicted.update({k: n * per for k, n in predicted_step_calls(
            cfg, gb // ranks, seq).items()})
        losses = out["losses"]
        times = [e["time"] for e in out["log"]]
        warm = sorted(times[1:])
        p50 = warm[(len(warm) - 1) // 2]
        res = {"arch": arch, "n_layers": cfg.n_layers, "reduced": cut,
               "params": n_params, "state_bytes": state_bytes,
               "ranks": ranks, "global_batch": gb, "seq_len": seq,
               "lr": lr, "warmup_steps": steps // 2,
               "extras": {k: list(v[0]) for k, v in
                          extra_batch_specs(cfg, gb).items()},
               "steps": len(losses), "losses": losses,
               "step0_check": {k: step0[k] for k in (
                   "loss_kernel_vs_f32", "grad_kernel_vs_f32", "ratio",
                   "worst_leaf")},
               "ckpt_step0_s": runtime.ckpt.stats[0]["device_to_host_s"],
               "first_step_s": times[0], "step_s_p50": p50,
               "step_s_max": warm[-1], "wall_s": wall,
               "tokens_per_s_warm": gb * seq / p50,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": launches, "expected_launches": expect,
               "predicted_launches": predicted,
               "bwd_by_design": designs,
               "host_rss_gb": _host_rss_gb()}
        print(f"train-family-{tag} {json.dumps(res)}", flush=True)
        if tag == "moe":
            # one more step of the same runtime, warm, under the profiler
            run = {"state": state, "resid": runtime._init_resid(state)}
            batch = {k: torch.as_tensor(v).cuda() for k, v in
                     family_batch_fn(cfg)(dcfg, steps).items()}

            def one_step():
                run["state"], metrics, run["resid"] = runtime._step_fn(
                    run["state"], batch, run["resid"])
                float(metrics["loss"])
                return 1
            profile_phase(torch, "train_step_moe", one_step)
            state = run["state"]
            del batch, run
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        runtime.release()
        del state, runtime
        torch.cuda.empty_cache()
        assert all(math.isfinite(x) for x in losses), res
        assert losses[-1] < losses[0], res
        assert launches == expect == predicted, (launches, expect,
                                                 predicted)
        assert designs["moe_gmm_bwd"]["wgmma"] == expect["moe_gmm_bwd"], \
            designs
        for name in ("mamba_scan_bwd", "mlstm_bwd"):
            assert designs[name]["mma.sync"] == expect[name], designs
        for name in counters:
            total[name] += launches[name]
        for name, by in designs.items():
            for design, count in by.items():
                total[f"{name}_by_design"][design] += count
        phase_time(f"train-family-{tag}")
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.collective_codec import ops as co
    from repro_torch.kernels.collective_codec import ref as cr
    from repro_torch.kernels.diff_merge import ops as dm
    from repro_torch.kernels.diff_merge import ref as dr
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mlstm import ops as ml_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.slstm import ops as sl_ops
    from repro_torch.models import transformer as tf

    # 1. environment
    last = [time.perf_counter()]

    def phase_time(name):
        """Print the wall time since the last mark (where the script's
        time limit goes) and the process's host memory once the phase's
        garbage is collected (the machine's limit is 96 GiB, and a
        phase's state held in a reference cycle outlives the phase until
        a full collection)."""
        now = time.perf_counter()
        gc.collect()
        print(f"phase-time {name} {now - last[0]:.1f}s "
              f"host_rss_gb={_host_rss_gb():.2f}", flush=True)
        last[0] = time.perf_counter()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _sh(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    nvcc_v = _sh([_build.nvcc(), "--version"]).splitlines()
    print(card, flush=True)
    print(f"env torch={torch.__version__} cuda={torch.version.cuda} "
          f"triton={triton_v} nvcc={nvcc_v[-1] if nvcc_v else '?'} "
          f"device={torch.cuda.get_device_name(0)}", flush=True)

    # 2. build every kernel source, all at once
    build_all(torch)
    phase_time("build")

    # first use of every serve shape, before anything else runs on the card
    cfg = get_config("llama3.2-1b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        params = tf.init_params(gen, cfg, device="cuda")
        warm_up(torch, cfg, params, MAX_LEN)
    phase_time("first-call")

    # 3. kernels vs plain versions
    rows = check_kernel(torch, fa_ops, fa_ref, F)
    bwd_rows = check_backward(torch, fa_ops, fa_ref, F)
    codec_rows = check_codec(torch, co, cr)
    dm_rows = check_diff_merge(torch, dm, dr)
    gmm_rows = check_moe_gmm(torch, get_config("granite-moe-1b-a400m"))
    gmm_rows += check_moe_gmm(torch, get_config("phi3.5-moe-42b-a6.6b"))
    gmm_bwd_rows = check_moe_gmm_bwd(torch)
    scan_rows = check_mamba_scan(torch, get_config("zamba2-2.7b"))
    scan_bwd_rows = check_mamba_scan_bwd(torch, get_config("zamba2-2.7b"))
    ml_rows = check_mlstm(torch, get_config("xlstm-1.3b"))
    ml_bwd_rows = check_mlstm_bwd(torch, get_config("xlstm-1.3b"))
    sl_rows = check_slstm(torch, get_config("xlstm-1.3b"))
    sl_bwd_rows = check_slstm_bwd(torch, get_config("xlstm-1.3b"))
    print(f"kernel-check host_rss_gb={_host_rss_gb():.2f}", flush=True)
    bad = [r for r in rows + bwd_rows + gmm_rows + gmm_bwd_rows + scan_rows
           + scan_bwd_rows + ml_rows + ml_bwd_rows + sl_rows + sl_bwd_rows
           if not r["ok"]] + \
        [r for r in codec_rows + dm_rows if not r["bit_exact"]]
    assert not bad, bad
    main_row = next(r for r in rows if r["B"] == 1 and r["S"] == 1024
                    and r["H"] == 32 and r["hd"] == 64 and r["window"] == 0
                    and r["causal"] and r["dtype"] == "bfloat16")
    bwd_row = next(r for r in bwd_rows if r["B"] == 2 and r["S"] == 1024
                   and r["H"] == 32 and r["hd"] == 64 and r["window"] == 0
                   and r["dtype"] == "bfloat16")
    codec_row = codec_rows[-1]          # the main path's 4-shard launch
    gmm_row = gmm_rows[0]               # a 1024-token prefill, bf16
    gmm_bwd_row = gmm_bwd_rows[0]       # granite's training shape, bf16
    scan_row = next(r for r in scan_rows if r["B"] == 1
                    and r["L"] == 1024 and r["dtype"] == "bfloat16"
                    and r["gates"] == "model")
    ml_row = ml_rows[0]                 # a 1024-token prefill, bf16
    # the training shapes, bf16, slow gates (few rows at the floor)
    scan_bwd_row = next(r for r in scan_bwd_rows if r["gates"] == "slow"
                        and r["dtype"] == "bfloat16" and not r["ds_fin"]
                        and r["inputs"] == "random")
    ml_bwd_row = ml_bwd_rows[0]
    sl_row = sl_rows[1]                 # train_4k's 1 x 4096
    sl_bwd_row = sl_bwd_rows[0]         # training's rank batch, 2 x 512
    phase_time("kernel-check")

    # 4. serve full-width llama3.2-1b
    with torch.no_grad():
        reqs, serve_launches = serve(torch, cfg, params, cfg.n_layers)
        check_prefill(torch, cfg, params, reqs, MAX_LEN)
        profile(torch, cfg, params)
    phase_time("serve")

    # 5. train full-width llama3.2-1b: checks, then the gang
    train_check(torch, cfg, params)
    sync_check(torch, cfg, params)
    phase_time("train-check")
    # the train state: params, and the f32 moments m and v; the int step
    state_bytes = state_nbytes(cfg)
    del params
    torch.cuda.empty_cache()
    _, train_launches = train(torch, cfg, state_bytes)
    phase_time("train")

    # 6. the data plane over the full-width train state; every kernel's
    # count is set to 0 before each path and read after it
    mods = {"flash_attention": (fa_ops, "launches"),
            "flash_attention_bwd": (fa_ops, "bwd_launches"),
            "collective_codec": (co, "launches"),
            "diff_merge": (dm, "launches"),
            "moe_gmm": (gmm_ops, "launches"),
            "moe_gmm_bwd": (gmm_ops, "bwd_launches"),
            "mamba_scan": (scan_ops, "launches"),
            "mamba_scan_bwd": (scan_ops, "bwd_launches"),
            "mlstm": (ml_ops, "launches"),
            "mlstm_bwd": (ml_ops, "bwd_launches"),
            "slstm": (sl_ops, "launches"),
            "slstm_bwd": (sl_ops, "bwd_launches")}
    plane = dict.fromkeys(mods, 0)

    # 5b. the analysis path (slice 15) against real steps, at the JAX
    # package's assigned shapes (slice 17)
    dryrun_phase(torch, mods)
    phase_time("dryrun")
    # 5c. a 500k-token context served through the window path (slice 17)
    torch.cuda.empty_cache()
    long_launches = long_context_serve(torch, mods)
    phase_time("long-context")

    def counted(path):
        for mod, attr in mods.values():
            setattr(mod, attr, 0)
        out = path()
        for name, (mod, attr) in mods.items():
            plane[name] += getattr(mod, attr)
        return out
    ds_res = counted(lambda: diffsync_check(torch, cfg))
    phase_time("diffsync-check")
    # ckpt runs CKPT_LAYERS of the 16 layers, for the script's time limit
    ckpt_cfg = cfg.with_(n_layers=CKPT_LAYERS)
    counted(lambda: ckpt_check(torch, ckpt_cfg, state_nbytes(ckpt_cfg)))
    print(f"data-plane-launches {json.dumps(plane)}", flush=True)
    assert plane["diff_merge"] > 0, plane
    phase_time("ckpt")

    # 7. the shared Fabric: train and serve gangs through run_trace, at
    # FABRIC_LAYERS of the 16 layers for the script's time limit
    torch.cuda.empty_cache()
    fabric_cfg = cfg.with_(n_layers=FABRIC_LAYERS)
    fabric = fabric_phase(torch, fabric_cfg, mods)
    phase_time("fabric")
    # 7b. the risk-aware spot wave (slice 16), after grow-with-drain
    spot = fabric_spot(torch, fabric_cfg, mods)
    phase_time("fabric-spot")
    # 7c. the twins of the JAX package's examples (slice 16)
    torch.cuda.empty_cache()
    examples = examples_phase(torch, mods)
    phase_time("examples")
    fabric = {name: fabric[name] + spot[name] + examples[name]
              for name in fabric}

    # 8. serve the MoE, hybrid (slice 4) and xLSTM (slice 5) families
    torch.cuda.empty_cache()
    fam = families(torch, mods, phase_time)
    assert fam["moe_gmm"] > 0 and fam["mamba_scan"] > 0 \
        and fam["mlstm"] > 0 and fam["slstm"] > 0, fam

    # 9. train the audio, VLM and MoE families (slice 11), the hybrid and
    # xLSTM ones (slice 13)
    torch.cuda.empty_cache()
    tfam = train_families(torch, mods, phase_time)
    assert tfam["moe_gmm_bwd"] > 0 and tfam["mamba_scan_bwd"] > 0 \
        and tfam["mlstm_bwd"] > 0 and tfam["slstm_bwd"] > 0, tfam

    # 9. results
    src = "src/repro_torch/kernels/"
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": src + "flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:32",
        "launches": serve_launches + train_launches["flash_attention"]
        + plane["flash_attention"] + fabric["flash_attention"]
        + fam["flash_attention"] + tfam["flash_attention"]
        + long_launches["flash_attention"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": src + "flash_attention/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:32",
        "launches": train_launches["flash_attention_bwd"]
        + plane["flash_attention_bwd"] + fabric["flash_attention_bwd"]
        + tfam["flash_attention_bwd"],
        "max_abs_err": bwd_row["max_abs_err"],
        "ms": bwd_row["ms"], "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"], "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"]}, {
        "name": "collective_codec", "route": "cuda",
        "source": src + "collective_codec/csrc/collective_codec.cu",
        "replaces": "src/repro/kernels/collective_codec/kernel.py:36",
        "launches": train_launches["collective_codec"]
        + plane["collective_codec"] + fabric["collective_codec"],
        "max_abs_err": codec_row["max_abs_err"],
        "ms": codec_row["ms"], "plain_ms": codec_row["plain_ms"],
        "bound_ms": codec_row["bound_ms"],
        "bound_by": codec_row["bound_by"], "library_ms": None}, {
        # the main path's shapes: the whole train state's fused sum pass
        "name": "diff_merge", "route": "cuda",
        "source": src + "diff_merge/csrc/diff_merge.cu",
        "replaces": "src/repro/kernels/diff_merge/kernel.py:64",
        "launches": plane["diff_merge"] + fabric["diff_merge"],
        "max_abs_err": 0.0 if ds_res["sum"]["bit_exact"] else None,
        "ms": ds_res["sum"]["kernel_ms"],
        "plain_ms": ds_res["sum"]["plain_ms"],
        "bound_ms": ds_res["sum"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None}, {
        "name": "moe_gmm", "route": "cuda",
        "source": src + "moe_gmm/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/kernel.py:28",
        "launches": fam["moe_gmm"] + tfam["moe_gmm"] + fabric["moe_gmm"],
        "max_abs_err": gmm_row["max_abs_err"],
        "ms": gmm_row["ms"], "plain_ms": gmm_row["plain_ms"],
        "bound_ms": gmm_row["bound_ms"], "bound_by": gmm_row["bound_by"],
        "library_ms": None}, {
        # the TPU kernel has no backward; this is its forward's gradient
        "name": "moe_gmm_bwd", "route": "cuda",
        "source": src + "moe_gmm/csrc/moe_gmm_bwd.cu",
        "replaces": "src/repro/kernels/moe_gmm/kernel.py:28",
        "launches": tfam["moe_gmm_bwd"] + fabric["moe_gmm_bwd"],
        "launches_by_design": tfam["moe_gmm_bwd_by_design"],
        "max_abs_err": gmm_bwd_row["max_abs_err"],
        "ms": gmm_bwd_row["ms"], "plain_ms": gmm_bwd_row["plain_ms"],
        "bound_ms": gmm_bwd_row["bound_ms"],
        "bound_by": gmm_bwd_row["bound_by"], "library_ms": None}, {
        "name": "mamba_scan", "route": "cuda",
        "source": src + "mamba_scan/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan/kernel.py:28",
        "launches": fam["mamba_scan"] + tfam["mamba_scan"]
        + long_launches["mamba_scan"],
        "max_abs_err": scan_row["max_abs_err"],
        "ms": scan_row["ms"], "plain_ms": scan_row["plain_ms"],
        "bound_ms": scan_row["bound_ms"], "bound_by": scan_row["bound_by"],
        "library_ms": None}, {
        # the TPU kernel has no backward; this is its forward's gradient
        "name": "mamba_scan_bwd", "route": "cuda",
        "source": src + "mamba_scan/csrc/mamba_scan_bwd.cu",
        "replaces": "src/repro/kernels/mamba_scan/kernel.py:28",
        "launches": tfam["mamba_scan_bwd"],
        "launches_by_design": tfam["mamba_scan_bwd_by_design"],
        "max_abs_err": scan_bwd_row["max_abs_err"],
        "ms": scan_bwd_row["ms"], "plain_ms": scan_bwd_row["plain_ms"],
        "bound_ms": scan_bwd_row["bound_ms"],
        "bound_by": scan_bwd_row["bound_by"], "library_ms": None}, {
        "name": "mlstm", "route": "cuda",
        "source": src + "mlstm/csrc/mlstm.cu",
        "replaces": "src/repro/kernels/mlstm/kernel.py:23",
        "launches": fam["mlstm"] + tfam["mlstm"],
        "max_abs_err": ml_row["max_abs_err"],
        "ms": ml_row["ms"], "plain_ms": ml_row["plain_ms"],
        "bound_ms": ml_row["bound_ms"], "bound_by": ml_row["bound_by"],
        "library_ms": None}, {
        # the TPU kernel has no backward; this is its forward's gradient
        "name": "mlstm_bwd", "route": "cuda",
        "source": src + "mlstm/csrc/mlstm_bwd.cu",
        "replaces": "src/repro/kernels/mlstm/kernel.py:23",
        "launches": tfam["mlstm_bwd"],
        "launches_by_design": tfam["mlstm_bwd_by_design"],
        "max_abs_err": ml_bwd_row["max_abs_err"],
        "ms": ml_bwd_row["ms"], "plain_ms": ml_bwd_row["plain_ms"],
        "bound_ms": ml_bwd_row["bound_ms"],
        "bound_by": ml_bwd_row["bound_by"], "library_ms": None}, {
        # the JAX package's lax.scan over _slstm_cell, which has no Pallas
        # kernel; serving's prefills and decode steps, training's forwards
        "name": "slstm", "route": "cuda",
        "source": src + "slstm/csrc/slstm.cu",
        "replaces": "src/repro/models/xlstm.py:289",
        "launches": fam["slstm"] + tfam["slstm"],
        "max_abs_err": sl_row["max_abs_err"],
        "ms": sl_row["ms"], "plain_ms": sl_row["plain_ms"],
        "bound_ms": sl_row["bound_ms"], "bound_by": sl_row["bound_by"],
        "library_ms": None}, {
        # its gradient (JAX differentiates the scan itself)
        "name": "slstm_bwd", "route": "cuda",
        "source": src + "slstm/csrc/slstm_bwd.cu",
        "replaces": "src/repro/models/xlstm.py:289",
        "launches": tfam["slstm_bwd"],
        "max_abs_err": sl_bwd_row["max_abs_err"],
        "ms": sl_bwd_row["ms"], "plain_ms": sl_bwd_row["plain_ms"],
        "bound_ms": sl_bwd_row["bound_ms"],
        "bound_by": sl_bwd_row["bound_by"], "library_ms": None}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
