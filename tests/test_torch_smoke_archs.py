"""The port's twin of tests/test_smoke_archs.py: for every architecture,
a reduced same-family config on the CPU, its own init and seeded inputs
(the audio frames and image tokens included): forward shapes and finite
values, train steps on one batch lower the loss, full-size parameter
counts, and gradient accumulation equal to the full batch's step for the
families the runtime trains.

On the CPU every kernel wrapper runs its plain version, which autograd
differentiates; the runtime trains every family (on the card the hybrid
and xLSTM families through the mamba_scan and mlstm backward kernels), so
every architecture is in ``TRAINED``."""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, reduced_config
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train_loop import extra_batch_specs
from repro_torch.weights import tree_leaves, tree_unflatten

torch.set_num_threads(2)   # several test workers share the cores

B, S = 2, 32
TRAINED = list(ARCH_IDS)


def _batch(cfg, seed=1, b=B):
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, S),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    for name, (shape, dtype) in extra_batch_specs(cfg, b).items():
        batch[name] = torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(dtype)
    return batch


def _state(cfg, ocfg):
    gen = torch.Generator().manual_seed(0)
    return M.init_train_state(gen, cfg, ocfg, device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_shapes_and_finite(arch):
    cfg = reduced_config(arch)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    batch = _batch(cfg)
    with torch.no_grad():
        logits, aux, _ = tf.forward(params, batch["tokens"], cfg,
                                    {k: batch[k] for k in ("frames", "img")
                                     if k in batch})
    assert tuple(logits.shape) == (B, S, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert bool(torch.isfinite(aux))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_decreases_loss(arch):
    cfg = reduced_config(arch)
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=1, total_steps=10)
    state = _state(cfg, ocfg)
    step = M.make_train_step(cfg, ocfg)
    batch = _batch(cfg)
    losses = []
    for _ in range(4):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]  # same-batch loss must drop


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_param_count_positive(arch):
    cfg = get_config(arch)
    n = M.count_params(cfg)
    na = M.count_params(cfg, active_only=True)
    assert n > 0 and 0 < na <= n
    if cfg.n_experts:
        assert na < n


@pytest.mark.parametrize("arch", TRAINED)
def test_grad_accum_matches_full_batch(arch):
    """Two microbatches of 2 accumulate to the step of the batch of 4 (for
    the MoE family, each microbatch routes its own groups, as the JAX
    package's do: its step is compared with the mean of the microbatches'
    gradients, taken one by one)."""
    cfg = reduced_config(arch)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _batch(cfg, b=4)
    s2, m2 = M.make_train_step(cfg, ocfg, grad_accum=2)(_state(cfg, ocfg),
                                                        batch)
    if cfg.n_experts:
        grad_fn = M.make_grad_fn(cfg)
        state = _state(cfg, ocfg)
        halves = [grad_fn(state["params"],
                          {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()})
                  for i in range(2)]
        grads = tree_unflatten(halves[0][1], [
            (a.float() + b.float()) / 2 for a, b in
            zip(tree_leaves(halves[0][1]), tree_leaves(halves[1][1]))])
        params, _, _ = adamw.apply(grads, state["opt"], state["params"],
                                   ocfg)
        s1 = {"params": params}
    else:
        s1, _ = M.make_train_step(cfg, ocfg, grad_accum=1)(
            _state(cfg, ocfg), batch)
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s2["params"])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=1e-4)
    assert np.isfinite(float(m2["loss"]))
