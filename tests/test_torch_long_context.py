"""The port's long-context serving against the JAX package, reduced
configs in f32, the JAX weights carried by ``params_from_numpy``, inputs
from a numpy seed:

* the windowed ring: ``ServeLoop(window=8)`` decodes, for dense and
  hybrid and every prompt length, the greedy tokens of the JAX package's
  windowed ``forward`` (position p of a prompt longer than the ring sits
  at slot p % 8, where decode looks for it); and the JAX ``ServeLoop``'s
  tokens where the two place the prompt alike (plen <= 8 or plen % 8 ==
  0).  The JAX ``ServeLoop`` keeps the last rows in slots 0..7 whatever
  the prompt's length: at plen 10 its tokens leave its own windowed
  forward's (a fact of the reference, not repaired there);
* the windowed prefill's trimmed K/V (its last ``window`` rows) pads into
  the decode states that the whole collection pads into;
* ``make_serve_step`` at ``decode_window``'s window near position 2^19
  over a seeded ring wrapped 127 times (RoPE at large positions), for the
  hybrid, xLSTM and dense families, atol 1e-4 as tests/test_torch_model.py.
  The JAX step runs op by op: under ``jax.jit`` on one device XLA folds
  the constant RoPE frequencies with a correctly rounded ``pow``, an ulp
  from its op-by-op (and its partitioned runtime's) ``pow`` on some of
  them, which at 2^19 is ~2e-3 rad of angle (``test_jax_rope_frequencies_
  depend_on_compilation``, a fact of the reference); the port's are the
  op-by-op ones, which the runtime tests pin;
* chip_smoke.py's decode maker of the ``dryrun`` phase, on the CPU.
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as JM
from repro.models import transformer as JT
from repro.runtime import serve_loop as JS
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.runtime import serve_loop as TS
from repro_torch.weights import params_from_numpy

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)   # several test workers share the cores

WINDOW = 8
PLENS = (7, 8, 10, 19, 24)
N_NEW = 6
B = 2
ATOL = 1e-4                # tests/test_torch_model.py's
RING_ARCHS = ("llama3.2-1b", "zamba2-2.7b")


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = jreg.reduced_config(arch)
    tcfg = treg.reduced_config(arch)
    npt = jax.tree.map(np.asarray, jax.jit(
        lambda k: JT.init_params(k, jcfg))(jax.random.PRNGKey(0)))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, npt), \
        params_from_numpy(npt, "cpu")


def _prompts(jcfg, plen):
    return np.random.default_rng(plen).integers(0, jcfg.vocab, (B, plen),
                                                dtype=np.int32)


def _serve(mod, cfg, params, prompts):
    """Greedy tokens (B, N_NEW) of ``mod.ServeLoop`` with the window."""
    loop = mod.ServeLoop(cfg, params, max_len=64, window=WINDOW)
    reqs = [mod.Request(rid=i, prompt=p, max_new_tokens=N_NEW)
            for i, p in enumerate(prompts)]
    loop.run(reqs)
    return np.asarray([r.out for r in reqs])


def _forward_greedy(jcfg, jp, prompts, out):
    """The JAX windowed forward's greedy token after the prompt and after
    each served token (teacher-forced on ``out``: greedy decoding itself
    where ``out`` is greedy)."""
    seq = np.concatenate([prompts, out[:, :-1]], axis=1)
    logits, _, _ = jax.jit(lambda p, t: JT.forward(
        p, t, jcfg, {"window": WINDOW}))(jp, jnp.asarray(seq))
    return np.asarray(jnp.argmax(logits[:, prompts.shape[1] - 1:], -1))


@pytest.mark.parametrize("plen", PLENS)
@pytest.mark.parametrize("arch", RING_ARCHS)
def test_windowed_serve_loop_matches_jax_windowed_forward(arch, plen):
    jcfg, tcfg, jp, tp = _models(arch)
    prompts = _prompts(jcfg, plen)
    out = _serve(TS, tcfg, tp, prompts)
    np.testing.assert_array_equal(out, _forward_greedy(jcfg, jp, prompts,
                                                       out))


@pytest.mark.parametrize("plen", [p for p in PLENS
                                  if p <= WINDOW or p % WINDOW == 0])
@pytest.mark.parametrize("arch", RING_ARCHS)
def test_windowed_serve_loop_matches_jax_serve_loop(arch, plen):
    """Where the JAX loop places the prompt's rows as decode reads them."""
    jcfg, tcfg, jp, tp = _models(arch)
    prompts = _prompts(jcfg, plen)
    np.testing.assert_array_equal(_serve(TS, tcfg, tp, prompts),
                                  _serve(JS, jcfg, jp, prompts))


def test_jax_serve_loop_misplaces_the_ring_reference_fact():
    """A fact of the reference: the JAX ``ServeLoop._pad_states`` keeps a
    10-token prompt's last 8 K/V rows in slots 0..7, where decode
    (position p at slot p % 8) looks for position 8 in slot 0; its tokens
    leave its own windowed forward's.  The port's loop keeps them."""
    jcfg, tcfg, jp, tp = _models("llama3.2-1b")
    prompts = _prompts(jcfg, 10)
    jout = _serve(JS, jcfg, jp, prompts)
    assert not np.array_equal(jout, _forward_greedy(jcfg, jp, prompts,
                                                    jout))
    tout = _serve(TS, tcfg, tp, prompts)
    np.testing.assert_array_equal(tout, _forward_greedy(jcfg, jp, prompts,
                                                        tout))


@pytest.mark.parametrize("plen", [10, 19])
@pytest.mark.parametrize("arch", RING_ARCHS)
def test_trimmed_prefill_pads_as_the_whole_collection(arch, plen):
    """The windowed prefill keeps each attention block's last WINDOW K/V
    rows; padded into decode states they equal what the whole
    collection pads into, and slot p % WINDOW holds position p."""
    _, tcfg, _, tp = _models(arch)
    tokens = torch.from_numpy(_prompts(tcfg, plen))
    _, trimmed = TM.make_prefill_step(tcfg, window=WINDOW)(
        tp, {"tokens": tokens})
    _, _, whole = TT.forward(tp, tokens, tcfg, {
        "collect_state": True, "window": WINDOW, "return_hidden": True})
    loop = TS.ServeLoop(tcfg, tp, max_len=64, window=WINDOW)
    a = loop._pad_states(trimmed, plen)
    b = loop._pad_states(whole, plen)
    kinds = tcfg.period()
    for kind, st_t, st_w, sa, sb in zip(kinds, trimmed, whole, a, b):
        for key in sa:
            assert torch.equal(sa[key], sb[key]), (kind, key)
        if kind in TT._ATTN_KINDS:
            assert st_t["k"].shape[2] == WINDOW < st_w["k"].shape[2]
            for p in range(plen - WINDOW, plen):
                assert torch.equal(sa["k"][:, :, p % WINDOW],
                                   st_w["k"][:, :, p])


LONG = SHAPES["long_500k"]


@pytest.mark.parametrize("arch,window", [
    ("zamba2-2.7b", TM.decode_window(treg.get_config("zamba2-2.7b"),
                                     LONG)),
    ("xlstm-1.3b", TM.decode_window(treg.get_config("xlstm-1.3b"), LONG)),
    # a dense arch's long_500k cell is skipped (decode_window 0): its
    # ring here is the hybrid's window
    ("llama3.2-1b", TM.LONG_CONTEXT_WINDOW)])
def test_serve_step_near_position_2_19_matches_jax(arch, window):
    jcfg, tcfg, jp, tp = _models(arch)
    max_len = LONG.seq_len
    jst = JT.init_decode_state(jcfg, B, max_len, jcfg.param_dtype(),
                               window=window)
    tst = TT.init_decode_state(tcfg, B, max_len, torch.float32,
                               window=window, device="cpu")
    rng = np.random.default_rng(5)
    for j_s, t_s in zip(jst, tst):
        for key in ("k", "v"):
            if key in t_s:
                ring = rng.standard_normal(t_s[key].shape).astype(
                    np.float32)
                j_s[key] = jnp.asarray(ring)
                t_s[key].copy_(torch.from_numpy(ring))
    if window:
        assert (max_len - 8) // tst[-1]["k"].shape[2] == 127
    jserve = JM.make_serve_step(jcfg, window=window)
    tserve = TM.make_serve_step(tcfg, window=window)
    tokens = rng.integers(0, jcfg.vocab, (B, 8), dtype=np.int32)
    for i, pos in enumerate(range(max_len - 8, max_len)):
        p = np.full((B, 1), pos, np.int32)
        with jax.disable_jit():
            jl, jst = jserve(jp, jst, jnp.asarray(tokens[:, i:i + 1]),
                             jnp.asarray(p))
        tl, tst = tserve(tp, tst, torch.from_numpy(tokens[:, i:i + 1]),
                         torch.from_numpy(p))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=1e-4)


def test_jax_rope_frequencies_depend_on_compilation():
    """A fact of the reference: ``repro.models.layers.rope_freqs`` gives
    other f32 values op by op than folded under ``jax.jit`` (an ulp
    apart on some), so its rotation at position 2^19 moves by ~1e-3 of
    |x| between the two; the port's frequencies are the op-by-op ones."""
    from repro.models import layers as JLy
    from repro_torch.models import layers as TLy
    hd, theta = 16, 10000.0
    eager = np.asarray(JLy.rope_freqs(hd, theta))
    folded = np.asarray(jax.jit(lambda: JLy.rope_freqs(hd, theta))())
    assert (eager != folded).any()
    np.testing.assert_array_equal(TLy.rope_freqs(hd, theta, "cpu").numpy(),
                                  eager)
    x = np.random.default_rng(0).standard_normal((1, 8, 2, hd)).astype(
        np.float32)
    pos = jnp.arange(LONG.seq_len - 8, LONG.seq_len)[None]
    apart = np.abs(np.asarray(jax.jit(lambda v: JLy.apply_rope(
        v, pos, theta))(x)) - np.asarray(JLy.apply_rope(jnp.asarray(x), pos,
                                                        theta))).max()
    assert apart > 1e-3


@pytest.mark.parametrize("name", ["decode_32k-llama1b", "long_500k-zamba2",
                                  "long_500k-xlstm"])
def test_dryrun_decode_maker_on_the_cpu(name):
    """The dryrun phase's decode cell on a reduced config: the state of
    ``init_decode_state`` at the shape's window, every KV row drawn, the
    position seq_len - 1; one step gives finite logits, writes the new
    row at its slot, and the meta arguments have the made ones' shapes."""
    cell = next(c for c in chip_smoke.DRYRUN_CELLS if c[0] == name)
    small = (cell[0], cell[1], cell[2], 2, cell[4])
    cfg = treg.reduced_config(cell[1]).with_(
        n_layers=len(treg.reduced_config(cell[1]).period()))
    got, shape, fn, meta, make = chip_smoke.dryrun_cell(torch, small, "cpu",
                                                        cfg=cfg)
    assert shape.name == cell[2] and shape.kind == "decode"
    params, states, tokens, pos = make()
    flat = lambda t: [x for s in t for x in s.values()]
    assert [tuple(x.shape) for x in flat(states)] == \
        [tuple(x.shape) for x in flat(meta[1])]
    assert tokens.shape == (2, 1) and int(pos[0, 0]) == shape.seq_len - 1
    window = TM.decode_window(got, shape)
    assert window == (4096 if cell[1] == "zamba2-2.7b" else 0)
    kv = [s for s in states if "k" in s]
    for s in kv:
        assert s["k"].shape[2] == (window or shape.seq_len)
        assert bool((s["k"] != 0).all()) and bool((s["v"] != 0).all())
    before = [s["k"].clone() for s in kv]
    logits, _ = fn(params, states, tokens, pos)
    assert logits.shape == (2, 1, got.vocab)
    assert bool(torch.isfinite(logits).all())
    slot = (shape.seq_len - 1) % (window or shape.seq_len)
    for s, old in zip(kv, before):
        assert not torch.equal(s["k"][:, :, slot], old[:, :, slot])
        rest = torch.ones(s["k"].shape[2], dtype=torch.bool)
        rest[slot] = False
        assert torch.equal(s["k"][:, :, rest], old[:, :, rest])


@pytest.mark.parametrize("s,window,block", [(37, 0, 8), (37, 5, 8),
                                            (64, 16, 16)])
def test_blocked_attention_ref_equals_attention_ref(s, window, block):
    """The long rows' plain flash (a block of query rows at a time) is
    ``attention_ref``."""
    from repro_torch.kernels.flash_attention import ref as FR
    rng = np.random.default_rng(s + window)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, h, s, 16)).astype(np.float32)) for h in (4, 2, 2))
    want = FR.attention_ref(q, k, v, causal=True, window=window)
    got = FR.attention_ref_blocked(q, k, v, window=window, block=block)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_scan_plain_by_heads_equals_the_plain_scan():
    """The long scan row's plain version, a few heads at a time."""
    from repro_torch.kernels.mamba_scan import ref as SR
    x, dt, a, b, c, _ = SR.scan_inputs(1, 128, 20, 8, 16, gates="slow",
                                       seed=3)
    y, s = chip_smoke._scan_plain_by_heads(SR, x, dt, a, b, c, 32)
    yr, sr = SR.ssd_chunked(x, dt, a, b, c, 32)
    torch.testing.assert_close(y, yr, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(s, sr, atol=1e-6, rtol=1e-6)


def test_planted_forward_faults_are_found_once():
    """The long rows' planted copies: each fault's text stands once in
    its source."""
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.mamba_scan import ops as SO
    from repro_torch.kernels.mamba_scan import ref as SR
    for path, (old, _) in ((FO._CSRC / "flash_attention.cu",
                            FR.FWD_RESCALE_FAULT),
                           (SO._SOURCE, SR.FWD_CARRY_FAULT)):
        assert path.read_text().count(old) == 1


def test_long_serve_lengths_fit_the_ring_and_the_scan():
    """chip_smoke's 500k serve and its f32 control: prompts and whole
    sequences are multiples of the scan's chunk (a ragged tail cannot be
    scanned), each prompt ends inside the ring at the same residue, and
    the long prompt is the long_500k shape's length less the new tokens."""
    cfg = treg.get_config(chip_smoke.LONG_ARCH)
    window = TM.decode_window(cfg, LONG)
    plen = LONG.seq_len - chip_smoke.LONG_NEW
    for p in (plen, chip_smoke.LONG_CONTROL):
        assert p % cfg.ssm_chunk == 0
        assert (p + chip_smoke.LONG_NEW) % cfg.ssm_chunk == 0
        assert p % window == plen % window != 0
