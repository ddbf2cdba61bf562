#!/usr/bin/env python3
"""Attribute xlstm-1.3b's step-0 gradient error at 8 layers, on one GPU.

    python3 attribute_xlstm.py
    python3 attribute_xlstm.py --sweep [--seeds 6] [--batches 2]

The step-0 check of ``chip_smoke.family_grad_check`` holds each gradient
leaf of the bf16 kernel path against an f32 witness, with the plain bf16
path as the yardstick: within 0.1, or within 1.25 times the plain path's
error.  This script runs xlstm-1.3b cut to 8 layers (one period) at the
check's rank batch (2 x 512) and prints, for each of the mLSTM forget
gates' bias leaves (``['blocks'][i]['mlstm']['bf']``), the error of:

* the mixed routes: the forward kernel with autograd of the plain version
  as its gradient, and the plain forward with the backward kernel;
* the forward kernel (csrc/mlstm.cu) as it is (three bf16 parts of each
  f32 operand), with two parts (``ref.FWD_PARTS_FAULT``), and with two
  parts for one of S, the C entering each chunk and wexp o V;
* the backward kernel (csrc/mlstm_bwd.cu) with one family of its
  tensor-core products, or all of them, on its f32 CUDA-core route
  instead (the two-part forward before it);
* the plain forward with one ulp added to or taken from a share of h's
  elements at random (a measure of how far bf16 noise alone moves the
  leaves).

Then, at the seven mLSTM layers' inputs captured from the kernel path:
the share of h's elements off the bf16 rounding of a float64 h, for the
plain version and each forward variant, and the error of the sum over
tokens of dlogf (1 - f), the form of the bias gradient, against float64
for the plain version and each backward variant.  Then both kernels'
times at the training shape, each forward variant in turns, and
``family_grad_check`` at 8 and at 16 layers.  Variant sources are
written under ``build/xlstm_attr/`` and built with nvcc.  Lines start
with ``attr-``; the card's name and power limit come first.

``--sweep`` runs only the step-0 check's rule at 8 layers over several
draws (the weights' seed, and the batch at data step 0, 1, ...): for
each draw the plain bf16 path, the kernel path with the forward in three
parts and in two, and the plain path with one ulp added to or taken from
h's elements at random at 0.05% and 0.15% (each forward's excess over the
plain version's share of h off a float64 h's rounding), each through
``family_grad_check``'s per-leaf rule against an f32 witness (a failed
leaf whose plain path is itself beyond 0.1 is judged by the kernel path
rerun in f32), and prints ``attr-sweep`` per draw and ``attr-sweep-rates``
(the share of draws each passes).
"""
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(REPO, "src"), REPO]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mlstm import ops as ml_ops  # noqa: E402
from repro_torch.kernels.mlstm import ref as ml_ref  # noqa: E402

# forward variants: text swaps of csrc/mlstm.cu
FWD = {"parts3": [],
       "parts2": [ml_ref.FWD_PARTS_FAULT],
       "C2": [("for (int p = 1; p < NPART; ++p) {     // C's lower parts",
               "for (int p = 1; p < 2; ++p) {     // C's lower parts")],
       "S2": [("        for (int p = 0; p < NPART; ++p) {\n"
               "          tc::mma_bf16(acc[mt][2 * np], as[p][mt]",
               "        for (int p = 0; p < 2; ++p) {\n"
               "          tc::mma_bf16(acc[mt][2 * np], as[p][mt]")],
       "W2": [("          for (int p = 0; p < NPART; ++p) {\n"
               "            tc::mma_bf16(acc[mt][2 * np], aw[p][mt]",
               "          for (int p = 0; p < 2; ++p) {\n"
               "            tc::mma_bf16(acc[mt][2 * np], aw[p][mt]")]}
# backward variants: products of csrc/mlstm_bwd.cu moved to the f32 route
# (its gemm's last but one argument, the route, set to 0)
_F32 = {"own_C": [("SKIP_LAST}, bt, B, D, D, bf, st));", 1)],
        "own_dC": [("SKIP_FIRST}, bt, B, D, D, bf, st));", 1)],
        "states": [("SKIP_FIRST}, bt, B, qm, D, bf, st));", 1),
                   ("SKIP_LAST}, bt, B, qm, D, bf, st));", 2)],
        "rows": [("R}, bt, B, qm, D, bf, st));", 3)],
        "all": [("bf, st));", 10)]}
BWD = {"as_is": []}
BWD.update({f"f32_{k}": [(old, old.replace("bf, st", "0, st"), n)
                         for old, n in v] for k, v in _F32.items()})


def _variant(source, name, swaps):
    text = source.read_text()
    for swap in swaps:
        old, new = swap[:2]
        n = swap[2] if len(swap) > 2 else 1
        assert text.count(old) == n, (name, old, text.count(old))
        text = text.replace(old, new)
    path = os.path.join(REPO, "build", "xlstm_attr", name, source.name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


def build_variants():
    """{name: library} for FWD (mlstm_<name>) and BWD (mlstm_bwd_<name>)."""
    jobs = {f"mlstm_{n}": (_variant(ml_ops._SOURCE, f"fwd_{n}", s), ml_ops._SIG)
            for n, s in FWD.items()}
    jobs.update({f"mlstm_bwd_{n}": (_variant(ml_ops._BWD_SOURCE, f"bwd_{n}",
                                             s), ml_ops._BWD_SIG)
                 for n, s in BWD.items()})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda n: _build.build(n, jobs[n][0]), jobs))
    libs = {n: _build.load(n, *jobs[n]) for n in jobs}
    print(f"attr-build {time.perf_counter() - t0:.1f}s", flush=True)
    return libs


def _flip(h, rate, gen):
    """h with one ulp added to or taken from a share ``rate`` of its
    elements (its bf16 words +- 1), drawn from ``gen``."""
    words = h.view(torch.int16)
    pick = torch.rand(h.shape, generator=gen, device=h.device) < rate
    step = torch.where(torch.rand(h.shape, generator=gen, device=h.device)
                       < 0.5, 1, -1).to(torch.int16)
    return torch.where(pick, words + step, words).view(torch.bfloat16)


def _routes(fwd, bwd):
    """An autograd Function running ``fwd(q, k, v, logi, logf, chunk)``
    -> h and ``bwd(q, k, v, logi, logf, dh, chunk)`` -> the five
    gradients."""
    class Mixed(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, logi, logf, chunk):
            ctx.save_for_backward(q, k, v, logi, logf)
            ctx.chunk = chunk
            out, (c, n, m) = fwd(q, k, v, logi, logf, chunk)
            return out, c, n, m

        @staticmethod
        def backward(ctx, dh, dc, dn, dm):
            return (*bwd(*ctx.saved_tensors, dh.contiguous(), ctx.chunk),
                    None)
    return Mixed.apply


def _plain_fwd(q, k, v, logi, logf, chunk):
    return ml_ref.mlstm_chunked(q, k, v, logi, logf, None, chunk)


def _plain_bwd(q, k, v, logi, logf, dh, chunk):
    return ml_ref.mlstm_chunked_grads(q, k, v, logi, logf, chunk, dh)


def _kernel_fwd(q, k, v, logi, logf, chunk):
    return ml_ops._launch(q, k, v, logi, logf, None, chunk)


def _kernel_bwd(q, k, v, logi, logf, dh, chunk):
    return ml_ops._launch_bwd(q, k, v, logi, logf, dh, chunk)


def model_level(libs, layers=8):
    """The bias leaves' errors of every run; the mLSTM layers' inputs (and
    dh) captured from the kernel path of the parent's kernels."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import pipeline as dp
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.train_loop import family_batch_fn
    from repro_torch.weights import tree_leaves_with_path, tree_map

    cfg = get_config("xlstm-1.3b").with_(n_layers=layers)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=4)
    grad_fn = model_mod.make_grad_fn(cfg)
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, device="cuda")
    batch = {k: v.cuda() for k, v in dp.shard_slice(
        family_batch_fn(cfg)(dcfg, 0), 0, 2).items()}
    params32 = tree_map(lambda t: t.float(), params)
    batch32 = {k: (v if k in ("tokens", "labels") else v.float())
               for k, v in batch.items()}
    names = [n for n, _ in tree_leaves_with_path(params32)]

    def grads(p, b):
        (_, _), g = grad_fn(p, b)
        torch.cuda.synchronize()
        return [t.float() for _, t in tree_leaves_with_path(g)]

    with cs._plain_paths():
        gw = grads(params32, batch32)
        gp = grads(params, batch)
    nw = [w.norm().item() for w in gw]
    rp = [(a - w).norm().item() / n for a, w, n in zip(gp, gw, nw)]
    bf = [i for i, n in enumerate(names) if n.endswith("['mlstm']['bf']")]
    captured = {"fwd": [], "bwd": []}

    def run(tag, fwd_lib, bwd_lib, apply=None, capture=False):
        fwd_launch, bwd_launch = ml_ops._launch, ml_ops._launch_bwd

        def launch(q, k, v, logi, logf, state, chunk):
            if capture and len(captured["fwd"]) < 7:
                captured["fwd"].append((q, k, v, logi, logf))
            return fwd_launch(q, k, v, logi, logf, state, chunk)

        def launch_bwd(q, k, v, logi, logf, dh, chunk, binds=None):
            if capture:
                captured["bwd"].append((q, k, v, logi, logf, dh.clone()))
            return bwd_launch(q, k, v, logi, logf, dh, chunk, binds)
        with mock.patch.object(ml_ops, "lib", lambda: fwd_lib), \
                mock.patch.object(ml_ops, "bwd_lib", lambda: bwd_lib), \
                mock.patch.object(ml_ops, "_launch", launch), \
                mock.patch.object(ml_ops, "_launch_bwd", launch_bwd), \
                (mock.patch.object(ml_ops._MLSTM, "apply", apply) if apply
                 else nullcontext()):
            g = grads(params, batch)
        rk = [(a - w).norm().item() / n for a, w, n in zip(g, gw, nw)]
        row = {"run": tag, "bf": {names[i]: [rk[i], rp[i]] for i in bf},
               "failed": [(names[i], rk[i], rp[i]) for i in range(len(names))
                          if not (rk[i] <= 0.1 or rk[i] <= 1.25 * rp[i])]}
        print(f"attr-model {json.dumps(row)}", flush=True)

    f2, b0 = libs["mlstm_parts2"], libs["mlstm_bwd_as_is"]
    run("kernel fwd parts2, plain bwd", f2, b0,
        _routes(_kernel_fwd, _plain_bwd))
    run("plain fwd, kernel bwd", f2, b0, _routes(_plain_fwd, _kernel_bwd))
    run("kernel fwd parts2, kernel bwd", f2, b0, capture=True)
    for name in BWD:
        if name != "as_is":
            run(f"kernel fwd parts2, kernel bwd {name}", f2,
                libs[f"mlstm_bwd_{name}"])
    for name in FWD:
        if name != "parts2":
            run(f"kernel fwd {name}, kernel bwd", libs[f"mlstm_{name}"], b0)
    for rate in (0.0016, 0.0003):
        gen = torch.Generator(device="cuda").manual_seed(7)
        run(f"plain fwd, h flipped at {rate}, plain bwd", f2, b0, _routes(
            lambda *a, _r=rate, _g=gen: (lambda o: (_flip(o[0], _r, _g),
                                                    o[1]))(_plain_fwd(*a)),
            _plain_bwd))
    return captured


NOISE_RATES = (0.0005, 0.0015)


def sweep(libs, seeds=6, batches=2, layers=8):
    """The per-leaf rule of ``family_grad_check`` over seeds x batches
    draws (weights' seed, data step), for the plain path, the kernel path
    with either forward and the plain path with h flipped at
    NOISE_RATES; prints each draw and the pass rates."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import pipeline as dp
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.train_loop import family_batch_fn
    from repro_torch.weights import tree_leaves_with_path, tree_map

    cfg = get_config("xlstm-1.3b").with_(n_layers=layers)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=4)
    grad_fn = model_mod.make_grad_fn(cfg)
    b0 = libs["mlstm_bwd_as_is"]
    tol = cs.TRAIN_TOL["grad"]
    passes = {}
    for seed in range(seeds):
        params = tf.init_params(
            torch.Generator(device="cuda").manual_seed(seed), cfg,
            device="cuda")
        params32 = tree_map(lambda t: t.float(), params)
        names = [n for n, _ in tree_leaves_with_path(params32)]
        for step in range(batches):
            batch = {k: v.cuda() for k, v in dp.shard_slice(
                family_batch_fn(cfg)(dcfg, step), 0, 2).items()}
            batch32 = {k: (v if k in ("tokens", "labels") else v.float())
                       for k, v in batch.items()}

            def grads(p, b, fwd_lib=libs["mlstm_parts3"], apply=None,
                      plain=False):
                with mock.patch.object(ml_ops, "lib", lambda: fwd_lib), \
                        mock.patch.object(ml_ops, "bwd_lib", lambda: b0), \
                        (mock.patch.object(ml_ops._MLSTM, "apply", apply)
                         if apply else nullcontext()), \
                        (cs._plain_paths() if plain else nullcontext()):
                    (_, _), g = grad_fn(p, b)
                torch.cuda.synchronize()
                return [t.float() for _, t in tree_leaves_with_path(g)]
            gw = grads(params32, batch32, plain=True)
            nw = [w.norm().item() or 1.0 for w in gw]

            def ratios(g):
                return [(a - w).norm().item() / n
                        for a, w, n in zip(g, gw, nw)]
            rp = ratios(grads(params, batch, plain=True))
            r32 = None
            row = {"seed": seed, "step": step}
            runs = {"kernel parts3": dict(fwd_lib=libs["mlstm_parts3"]),
                    "kernel parts2": dict(fwd_lib=libs["mlstm_parts2"])}
            for rate in NOISE_RATES:
                gen = torch.Generator(device="cuda").manual_seed(
                    1000 * seed + step)
                runs[f"plain, h flipped at {rate}"] = dict(apply=_routes(
                    lambda *a, _r=rate, _g=gen: (lambda o: (
                        _flip(o[0], _r, _g), o[1]))(_plain_fwd(*a)),
                    _plain_bwd))
            for tag, kw in runs.items():
                rk = ratios(grads(params, batch, **kw))
                bad = [i for i in range(len(names))
                       if not (rk[i] <= tol or rk[i] <= 1.25 * rp[i])]
                drifted = [i for i in bad if rp[i] > tol]
                if drifted and r32 is None:
                    r32 = ratios(grads(params32, batch32))
                ok = (all(rp[i] > tol for i in bad)
                      and (not bad or all(r <= tol for r in r32)))
                worst = max(range(len(names)), key=lambda i: rk[i] / max(
                    tol, 1.25 * rp[i]))
                row[tag] = {"pass": ok, "failed": [
                    (names[i], round(rk[i], 4), round(rp[i], 4))
                    for i in bad if rp[i] <= tol],
                    "worst": (names[worst], round(rk[worst], 4),
                              round(rp[worst], 4))}
                passes.setdefault(tag, []).append(ok)
            print(f"attr-sweep {json.dumps(row)}", flush=True)
            del batch, batch32, gw
        del params, params32
        torch.cuda.empty_cache()
    print("attr-sweep-rates " + json.dumps(
        {k: f"{sum(v)}/{len(v)}" for k, v in passes.items()}), flush=True)


def _sum_err(dlogf, lf, ref):
    s = (dlogf.double() * (1 - lf.double().exp())).sum(dim=(0, 1))
    return ((s - ref).norm() / ref.norm()).item()


def _dlogf64(q, k, v, logi, logf, dh, chunk=128):
    """dlogf of the chunked mLSTM from the zero state, by autograd in
    float64."""
    leaves = [t.double().requires_grad_() for t in (q, k, v, logi, logf)]
    bs, length, h, hd = q.shape
    f64 = dict(dtype=torch.float64, device=q.device)
    state = (torch.zeros((bs, h, hd, hd), **f64),
             torch.zeros((bs, h, hd), **f64),
             torch.full((bs, h), ml_ref.NEG, **f64))
    outs = []
    with torch.enable_grad():
        for i in range(0, length, chunk):
            ht, state = ml_ref.mlstm_chunk_body(
                *(x[:, i:i + chunk] for x in leaves), state)
            outs.append(ht)
        return torch.autograd.grad(torch.cat(outs, 1), leaves[4],
                                   dh.double())[0]


def kernel_level(libs, captured):
    stream = torch.cuda.current_stream().cuda_stream
    for i, ins in enumerate(captured["fwd"]):
        h64, _ = ml_ref.mlstm_float64(*ins, 128)
        hr = h64.to(torch.bfloat16)
        hp, _ = ml_ref.mlstm_chunked(*ins, None, 128)
        row = {"layer_call": i, "plain": (hp != hr).float().mean().item()}
        for name in FWD:
            err, h, _ = ml_ops.call(libs[f"mlstm_{name}"], *ins, None, 128,
                                    stream)
            assert err == 0, (name, err)
            row[name] = (h != hr).float().mean().item()
        print(f"attr-h-off {json.dumps(row)}", flush=True)
    for i, (q, k, v, li, lf, dh) in enumerate(captured["bwd"]):
        s64 = (_dlogf64(q, k, v, li, lf, dh) * (1 - lf.double().exp())
               ).sum(dim=(0, 1))
        plain = _plain_bwd(q, k, v, li, lf, dh, 128)[4]
        row = {"layer_call": i, "plain": _sum_err(plain, lf, s64)}
        for name in BWD:
            err, got = ml_ops.call_bwd(libs[f"mlstm_bwd_{name}"], q, k, v,
                                       li, lf, dh, 128, stream)
            assert err == 0, (name, err)
            row[name] = _sum_err(got[4], lf, s64)
        print(f"attr-bias-sum-err {json.dumps(row)}", flush=True)


def timing(libs):
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for tag, (b, length) in {"serve 1x1024": (1, 1024),
                             "train 2x512": (2, 512)}.items():
        q, k, v, li, lf, dh = ml_ref.grad_inputs(
            b, length, 4, 1024, gates="slow", dtype=torch.bfloat16, seed=2,
            device="cuda")
        for name in ("parts2", "parts3", "parts3", "parts2"):
            lib = libs[f"mlstm_{name}"]
            res.setdefault(f"mlstm {tag} {name}", []).append(cs._time_ms(
                lambda: ml_ops.call(lib, q, k, v, li, lf, None, 128, stream),
                iters=20))
    blib = libs["mlstm_bwd_as_is"]
    res["mlstm_bwd train 2x512"] = [cs._time_ms(
        lambda: ml_ops.call_bwd(blib, q, k, v, li, lf, dh, 128, stream),
        iters=20) for _ in range(2)]
    print(f"attr-time-ms {json.dumps(res)}", flush=True)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--batches", type=int, default=2)
    args = ap.parse_args(argv)
    print(cs._sh(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants()
    if args.sweep:
        sweep(libs, args.seeds, args.batches)
        return 0
    timing(libs)
    captured = model_level(libs)
    kernel_level(libs, captured)
    del captured
    torch.cuda.empty_cache()
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig
    for layers in (8, 16):
        cfg = get_config("xlstm-1.3b").with_(n_layers=layers)
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=4)
        try:
            cs.family_grad_check(torch, cfg, dcfg, 2)
            print(f"attr-check {layers} layers passed", flush=True)
        except AssertionError:
            print(f"attr-check {layers} layers failed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
