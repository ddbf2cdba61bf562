"""The port's serving path against the JAX package: request streams, the
continuous and fixed-batch loops (greedy tokens on the same weights),
bit-exact snapshot resume, and the serve CLI."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import telemetry as jtel
from repro.models import transformer as JT
from repro.runtime import admission as JA
from repro.runtime import serve_loop as JS
from repro_torch.configs import registry as treg
from repro_torch.core import telemetry as ttel
from repro_torch.runtime import admission as TA
from repro_torch.runtime import serve_loop as TS
from repro_torch.weights import params_from_numpy

torch.set_num_threads(2)   # several test workers share the cores

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _models(n_layers=2, vocab=64, arch="llama3.2-1b"):
    jcfg = jreg.reduced_config(arch).with_(n_layers=n_layers, vocab=vocab)
    tcfg = treg.reduced_config(arch).with_(n_layers=n_layers, vocab=vocab)
    jp = jax.jit(lambda k: JT.init_params(k, jcfg))(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("regime", ["poisson", "diurnal", "burst"])
def test_request_stream_identical_to_jax(regime):
    kw = dict(regime=regime, vocab=97, prompt_lens=(3, 40),
              max_new=(2, 9), priority_classes=[(0, 1.0), (1, 3.0)])
    a = JA.request_stream(40, 1.5, 11, **kw)
    b = TA.request_stream(40, 1.5, 11, **kw)
    assert len(a) == len(b) == 40
    for x, y in zip(a, b):
        assert x.arrival == y.arrival and x.rid == y.rid
        assert x.priority == y.priority
        assert x.max_new_tokens == y.max_new_tokens
        assert x.prompt.dtype == y.prompt.dtype
        assert np.array_equal(x.prompt, y.prompt)


def _copies(reqs, mod):
    return [mod.Request(rid=r.rid, prompt=r.prompt.copy(),
                        max_new_tokens=r.max_new_tokens,
                        priority=r.priority, arrival=r.arrival)
            for r in reqs]


def test_continuous_open_loop_tokens_identical_to_jax():
    """Ragged prompts across buckets, admission mid-generation."""
    jcfg, tcfg, jp, tp = _models()
    base = JA.request_stream(6, 0.8, 5, vocab=64, prompt_lens=(3, 14),
                             max_new=(2, 8))
    jreqs, treqs = _copies(base, JS), _copies(base, TS)
    jloop = JS.ContinuousServeLoop(jcfg, jp, slots=3, max_len=32)
    tloop = TS.ContinuousServeLoop(tcfg, tp, slots=3, max_len=32)
    with jtel.recording() as jrec:
        jrep = JA.run_open_loop(jloop, jreqs)
    trec = ttel.enable()
    try:
        trep = TA.run_open_loop(tloop, treqs)
    finally:
        ttel.disable()
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    # same instrumentation: counters, gauges, virtual-clock histograms
    js, ts = jrec.summary(), trec.summary()
    for key in ("counters", "gauges", "histograms", "span_counts", "tracks"):
        assert ts[key] == js[key], key
    assert ts["counters"]["serve.admitted"] == 6
    assert dataclasses.asdict(tloop.stats) == dataclasses.asdict(jloop.stats)
    assert tloop.stats.admitted == 6 and tloop.done_rids == jloop.done_rids
    for a, b in zip(jreqs, treqs):
        assert a.out == b.out, (a.rid, a.out, b.out)
        assert (a.t_admit, a.t_first, a.t_done) == \
            (b.t_admit, b.t_first, b.t_done)


def test_fixed_batch_tokens_identical_to_jax():
    jcfg, tcfg, jp, tp = _models()
    base = JA.request_stream(5, 0.8, 6, vocab=64, prompt_lens=(9, 9),
                             max_new=(2, 7))
    jreqs, treqs = _copies(base, JS), _copies(base, TS)
    jrep = JA.run_fixed_batch(JS.ServeLoop(jcfg, jp, max_len=32), jreqs, 4)
    trep = TA.run_fixed_batch(TS.ServeLoop(tcfg, tp, max_len=32), treqs, 4)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    for a, b in zip(jreqs, treqs):
        assert a.out == b.out, (a.rid, a.out, b.out)


def test_continuous_matches_fixed_batch_tokens():
    _, tcfg, _, tp = _models()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 64, 8, dtype=np.int32) for _ in range(2)]
    mk = lambda: [TS.Request(rid=i, prompt=p.copy(), max_new_tokens=5)
                  for i, p in enumerate(prompts)]
    ref = TS.ServeLoop(tcfg, tp, max_len=32).run(mk())
    cont = TS.ContinuousServeLoop(tcfg, tp, slots=2, max_len=32)
    reqs = cont.run(mk())
    for a, b in zip(ref, reqs):
        assert a.out == b.out
    assert cont.stats.decoded_tokens == sum(len(r.out) for r in reqs)


def test_snapshot_mid_generation_resumes_bit_exact():
    _, tcfg, _, tp = _models()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 64, n, dtype=np.int32) for n in (5, 3, 9)]

    def mk():
        return [TS.Request(rid=i, prompt=prompts[i].copy(),
                           max_new_tokens=[6, 3, 4][i]) for i in range(3)]

    def drive(loop, reqs, snapshot_at=None):
        loop.admit(reqs[0])
        loop.admit(reqs[1])
        snap = None
        for step in range(4):
            loop.decode_step()
            if step == 2:                 # r1 (max_new=3) just freed
                assert loop.admit(reqs[2]) is not None
            if snapshot_at == step:
                snap = loop.serve_state()
        return snap

    ref = mk()
    ref_loop = TS.ContinuousServeLoop(tcfg, tp, slots=2, max_len=32)
    drive(ref_loop, ref)
    while not ref_loop.done:
        ref_loop.decode_step()

    mine = mk()
    loop1 = TS.ContinuousServeLoop(tcfg, tp, slots=2, max_len=32)
    snap = drive(loop1, mine, snapshot_at=3)
    assert loop1.done_rids == [1] and set(loop1.occupied_rids()) == {0, 2}
    frozen = [t.clone() for t in (snap["states"][0]["k"], snap["cur"])]
    loop1.decode_step()              # the live loop moves on...
    assert torch.equal(snap["states"][0]["k"], frozen[0])   # ...not the snap
    assert torch.equal(snap["cur"], frozen[1])

    loop2 = TS.ContinuousServeLoop(tcfg, tp, slots=2, max_len=32)
    loop2.load_serve_state(snap)
    loop2.adopt_requests(mine)
    assert len(mine[0].out) == 4                 # rolled back to the snap
    while not loop2.done:
        loop2.decode_step()
    for a, b in zip(ref, mine):
        assert a.out == b.out
    assert sorted(loop2.done_rids) == [0, 1, 2]
    assert torch.equal(loop2._states[0]["k"], ref_loop._states[0]["k"])


def test_fixed_loop_snapshot_resumes_in_fresh_loop():
    _, tcfg, _, tp = _models()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 64, 6, dtype=np.int32) for _ in range(3)]
    mk = lambda: [TS.Request(rid=i, prompt=p.copy(), max_new_tokens=4 + i)
                  for i, p in enumerate(prompts)]
    ref = TS.ServeLoop(tcfg, tp, max_len=16).run(mk())
    loop = TS.ServeLoop(tcfg, tp, max_len=16)
    reqs = mk()
    loop.start(reqs)
    loop.decode_step()
    loop.decode_step()
    snap = loop.serve_state()
    fresh = TS.ServeLoop(tcfg, tp, max_len=16)
    fresh.load_serve_state(snap)
    restored = list(fresh._reqs)
    assert [len(r.out) for r in restored] == [2, 2, 2]
    while fresh.decode_step():
        pass
    assert fresh.done and len(restored) == len(ref)
    for a, b in zip(ref, restored):
        assert a.out == b.out


def test_serve_cli_runs_on_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "2"}
    trace = tmp_path / "serve_trace.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "llama3.2-1b", "--requests", "6", "--engine", "both",
         "--prompt-len", "16", "--new-tokens", "8",
         "--emit-trace", str(trace)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout)
    assert res["continuous"]["finished"] == res["fixed"]["finished"] == 6
    assert res["device"] == "cpu" and res["continuous_speedup"] > 0
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e["name"] == "serve.decode_step" for e in events)
    summary = json.loads((tmp_path / "serve_trace.json.summary.json")
                         .read_text())
    assert summary["counters"]["serve.admitted"] == 6
