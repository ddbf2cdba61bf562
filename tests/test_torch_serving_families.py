"""The port's serving loops on the MoE (granite-moe-1b-a400m,
phi3.5-moe-42b-a6.6b), hybrid (zamba2-2.7b) and xLSTM (xlstm-1.3b)
families against the JAX package's,
on the same weights (reduced configs, 2 layers, vocab 64, f32): greedy
tokens of the continuous and fixed-batch loops equal the JAX loops',
continuous equals fixed-batch (the mirror of tests/test_serving.py:301),
a mixed-slot snapshot resumes exactly (the mirror of :336), a splice
keeps the recurrent leaves whole, and the serve CLI runs every family."""
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
from repro.models import transformer as JT
from repro.runtime import admission as JA
from repro.runtime import serve_loop as JS
from repro_torch.configs import registry as treg
from repro_torch.runtime import admission as TA
from repro_torch.runtime import serve_loop as TS
from repro_torch.weights import params_from_numpy

torch.set_num_threads(2)   # several test workers share the cores

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# phi3.5-moe's reduced config has 4 experts, so the JAX layer's sharding
# pin (n_experts % 16 == 0) does not fire outside a mesh
MOE_ARCHS = ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b")
FAMILIES = ["zamba2-2.7b", *MOE_ARCHS, "xlstm-1.3b"]


def _models(arch, **kw):
    jcfg = jreg.reduced_config(arch).with_(n_layers=2, vocab=64, **kw)
    tcfg = treg.reduced_config(arch).with_(n_layers=2, vocab=64, **kw)
    jp = jax.jit(lambda k: JT.init_params(k, jcfg))(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _copies(reqs, mod):
    return [mod.Request(rid=r.rid, prompt=r.prompt.copy(),
                        max_new_tokens=r.max_new_tokens,
                        priority=r.priority, arrival=r.arrival)
            for r in reqs]


@pytest.mark.parametrize("arch", FAMILIES)
def test_continuous_open_loop_tokens_identical_to_jax(arch):
    """Ragged prompts (exact-length prefill for the recurrent zamba2 and
    xlstm, buckets for granite), admission mid-generation, default
    capacity."""
    jcfg, tcfg, jp, tp = _models(arch)
    base = JA.request_stream(6, 0.8, 5, vocab=64, prompt_lens=(3, 14),
                             max_new=(2, 8))
    jreqs, treqs = _copies(base, JS), _copies(base, TS)
    jloop = JS.ContinuousServeLoop(jcfg, jp, slots=3, max_len=32)
    tloop = TS.ContinuousServeLoop(tcfg, tp, slots=3, max_len=32)
    assert tloop._exact_prefill == jloop._exact_prefill == \
        (arch not in MOE_ARCHS)
    jrep = JA.run_open_loop(jloop, jreqs)
    trep = TA.run_open_loop(tloop, treqs)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert dataclasses.asdict(tloop.stats) == dataclasses.asdict(jloop.stats)
    for a, b in zip(jreqs, treqs):
        assert a.out == b.out, (arch, a.rid, a.out, b.out)


@pytest.mark.parametrize("arch", FAMILIES)
def test_fixed_batch_tokens_identical_to_jax(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    base = JA.request_stream(5, 0.8, 6, vocab=64, prompt_lens=(9, 9),
                             max_new=(2, 7))
    jreqs, treqs = _copies(base, JS), _copies(base, TS)
    jrep = JA.run_fixed_batch(JS.ServeLoop(jcfg, jp, max_len=32), jreqs, 4)
    trep = TA.run_fixed_batch(TS.ServeLoop(tcfg, tp, max_len=32), treqs, 4)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    for a, b in zip(jreqs, treqs):
        assert a.out == b.out, (arch, a.rid, a.out, b.out)


@pytest.mark.parametrize("arch", FAMILIES)
def test_continuous_matches_fixed_batch_tokens(arch):
    # no-drop capacity for the MoE configs: lanes are then independent
    kw = {"capacity_factor": 8.0} if arch in MOE_ARCHS else {}
    _, tcfg, _, tp = _models(arch, **kw)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 64, 8, dtype=np.int32) for _ in range(2)]
    mk = lambda: [TS.Request(rid=i, prompt=p.copy(), max_new_tokens=5)
                  for i, p in enumerate(prompts)]
    ref = TS.ServeLoop(tcfg, tp, max_len=32).run(mk())
    cont = TS.ContinuousServeLoop(tcfg, tp, slots=2, max_len=32)
    reqs = cont.run(mk())
    for a, b in zip(ref, reqs):
        assert a.out == b.out, (arch, a.out, b.out)
    assert cont.stats.decoded_tokens == sum(len(r.out) for r in reqs)
    assert cont.stats.finished == len(reqs)


def _snapshot_resumes_exactly(arch, leaf):
    """Snapshot a loop with mixed slots (one lane done, one mid-way, one
    just admitted), resume it in a fresh loop: the tokens and every state
    buffer equal an uninterrupted run's.  ``leaf`` of the first period
    position's state must be frozen in the snapshot."""
    _, tcfg, _, tp = _models(arch)
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
    pos = 1 if arch == "xlstm-1.3b" else 0     # (sLSTM, mLSTM) period
    frozen = snap["states"][pos][leaf].clone()
    loop1.decode_step()              # the live loop moves on...
    assert torch.equal(snap["states"][pos][leaf], frozen)   # ...not the snap
    loop2 = TS.ContinuousServeLoop(tcfg, tp, slots=2, max_len=32)
    loop2.load_serve_state(snap)
    loop2.adopt_requests(mine)
    while not loop2.done:
        loop2.decode_step()
    for a, b in zip(ref, mine):
        assert a.out == b.out
    assert sorted(loop2.done_rids) == [0, 1, 2]
    for big, want in zip(loop2._states, ref_loop._states):
        for key in big:
            assert torch.equal(big[key], want[key]), key


def test_zamba2_mixed_slot_snapshot_resumes_exactly():
    _snapshot_resumes_exactly("zamba2-2.7b", "ssm")


def test_xlstm_mixed_slot_snapshot_resumes_exactly():
    """The mLSTM's matrix memory, updated in place by every decode step,
    is copied into the snapshot, not shared with the live loop."""
    _snapshot_resumes_exactly("xlstm-1.3b", "c")


def test_splice_keeps_the_mamba_state_whole():
    """The ssm leaf (n_per, slots, H, P, N) is 5-D like a KV leaf; its H
    axis is not a sequence axis, so a splice copies it whole."""
    _, tcfg, _, tp = _models("zamba2-2.7b")
    loop = TS.ContinuousServeLoop(tcfg, tp, slots=3, max_len=32)
    prompt = np.arange(7, dtype=np.int32)
    slot = loop.admit(TS.Request(rid=0, prompt=prompt, max_new_tokens=2))
    _, pre = TS.make_ragged_prefill(tcfg)(
        tp, {"tokens": torch.from_numpy(prompt[None])}, 7)
    mamba, attn = loop._states
    assert mamba["ssm"].dim() == 5
    assert torch.equal(mamba["ssm"][:, slot], pre[0]["ssm"][:, 0])
    assert torch.equal(mamba["conv_x"][:, slot], pre[0]["conv_x"][:, 0])
    assert torch.equal(attn["k"][:, slot, :7], pre[1]["k"][:, 0])
    assert bool((attn["k"][:, slot, 7:] == 0).all())


def test_splice_keeps_the_mlstm_matrix_memory_whole():
    """The mLSTM's c leaf (n_per, slots, H, hd, hd) is 5-D like a KV
    leaf, and row.shape[1] == big.shape[2] == H, so a splice copies it
    whole; the sLSTM leaves (n_per, slots, d) are copied whole too."""
    _, tcfg, _, tp = _models("xlstm-1.3b")
    loop = TS.ContinuousServeLoop(tcfg, tp, slots=3, max_len=32)
    prompt = np.arange(7, dtype=np.int32)
    slot = loop.admit(TS.Request(rid=0, prompt=prompt, max_new_tokens=2))
    _, pre = TS.make_ragged_prefill(tcfg)(
        tp, {"tokens": torch.from_numpy(prompt[None])}, 7)
    slstm, mlstm = loop._states
    assert mlstm["c"].dim() == 5
    assert mlstm["c"].shape[2] == tcfg.n_heads
    for state, want in ((slstm, pre[0]), (mlstm, pre[1])):
        for key in state:
            assert torch.equal(state[key][:, slot], want[key][:, 0]), key
    assert bool((mlstm["c"][:, slot] != 0).any())
    assert bool((mlstm["c"][:, slot + 1] == 0).all())


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_cli_runs_the_family_on_cpu(arch):
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "2"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", arch, "--requests", "4", "--engine", "both",
         "--prompt-len", "16", "--new-tokens", "6"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout)
    assert res["continuous"]["finished"] == res["fixed"]["finished"] == 4
    assert res["arch"] == arch and res["device"] == "cpu"
