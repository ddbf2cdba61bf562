"""The port's moe_gmm plain version and wrapper layout against the JAX
package's Pallas kernel (interpret mode) and its oracle, on the same
numpy inputs.  Tolerance: the JAX kernel test's own (tests/test_kernels.py
:149-165), atol 1e-5 / rtol 1e-4 in f32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm import kernel as JK
from repro.kernels.moe_gmm import ops as JO
from repro.kernels.moe_gmm import ref as JR
from repro_torch.kernels.moe_gmm import ops as TO
from repro_torch.kernels.moe_gmm import ref as TR

torch.set_num_threads(2)   # several test workers share the cores

ATOL, RTOL = 1e-5, 1e-4


def _inputs(e, m, d, ff, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, m, d)).astype(np.float32) * 0.5
    w1, w3 = (rng.standard_normal((e, d, ff)).astype(np.float32) * 0.05
              for _ in range(2))
    w2 = rng.standard_normal((e, ff, d)).astype(np.float32) * 0.05
    return x, w1, w2, w3


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# the JAX kernel test's three shapes, both acts, M = 8 (decode) and an M
# that forces the JAX wrapper's M block under 128 (96 -> 32)
SHAPES = [(4, 256, 64, 256), (2, 128, 128, 512), (8, 64, 32, 128),
          (4, 8, 64, 256), (2, 96, 64, 128)]


@pytest.mark.parametrize("e,m,d,ff", SHAPES)
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_plain_matches_jax_kernel_and_oracle(e, m, d, ff, act):
    x, w1, w2, w3 = _inputs(e, m, d, ff, e * m + d)
    out = TR.expert_ffn_ref(*_t(x, w1, w2, w3), act=act)
    bm = min(64, m)
    while m % bm:
        bm //= 2
    jk = JK.expert_ffn(x, w1, w2, w3, act=act, block_m=bm,
                       block_f=min(128, ff), interpret=True)
    jr = JR.expert_ffn_ref(x, w1, w2, w3, act=act)
    assert out.dtype == torch.float32 and out.shape == (e, m, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(jk), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jr), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("g,e,c,d,ff,act", [(2, 4, 16, 64, 128, "silu"),
                                            (1, 8, 8, 32, 64, "gelu"),
                                            (3, 4, 12, 64, 96, "silu")])
def test_wrapper_layout_matches_jax_ops(g, e, c, d, ff, act):
    """(G, E, C, d) in and out, experts outermost inside, as ops.py:27-33."""
    rng = np.random.default_rng(g * c)
    xe = rng.standard_normal((g, e, c, d)).astype(np.float32) * 0.5
    _, w1, w2, w3 = _inputs(e, 1, d, ff, c)
    before = TO.launches
    out = TO.expert_ffn(*_t(xe, w1, w2, w3), act=act)
    assert TO.launches == before          # the CPU runs the plain version
    want = JO.expert_ffn(xe, w1, w2, w3, act=act, interpret=True)
    assert out.shape == (g, e, c, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_bf16_plain_keeps_h_in_f32_and_rounds_once():
    """bf16 in, bf16 out: the plain version equals the f32 FFN of the
    bf16 inputs rounded once (the JAX kernel's arithmetic)."""
    x, w1, w2, w3 = _inputs(2, 16, 32, 64, 7)
    xb, w1b, w2b, w3b = (t.bfloat16() for t in _t(x, w1, w2, w3))
    out = TR.expert_ffn_ref(xb, w1b, w2b, w3b)
    f32 = TR.expert_ffn_ref(*(t.float() for t in (xb, w1b, w2b, w3b)))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, f32.bfloat16())
    jx = [jnp.asarray(np.asarray(t.float()), jnp.bfloat16)
          for t in (xb, w1b, w2b, w3b)]
    want = JR.expert_ffn_ref(*jx)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_wrapper_rejects_bad_shapes_and_act():
    x, w1, w2, w3 = _t(*_inputs(2, 8, 16, 32, 0))
    with pytest.raises(ValueError, match="act"):
        TO.expert_ffn_kernel_layout(x, w1, w2, w3, act="relu")
    with pytest.raises(ValueError, match="shapes"):
        TO.expert_ffn_kernel_layout(x, w1, w2.transpose(1, 2), w3)


@pytest.mark.parametrize("e,m,d,ff,grid", [
    # granite prefill: gate-up 3 M-tiles of 128 x 8 ff-tiles of 64,
    # down 5 M-tiles of 64 x 4 d-tiles of 256
    (32, 320, 1024, 512, ((3, 8, 32), (5, 4, 32))),
    (16, 160, 4096, 6400, ((2, 100, 16), (3, 16, 16))),  # phi3.5 prefill
    (16, 2, 4096, 6400, ((1, 100, 16), (1, 64, 16))),    # phi3.5 decode
    (2, 40, 1100, 96, ((1, 2, 2), (1, 5, 2))),           # ragged tiles
    (65535, 1, 8, 8, ((1, 1, 65535), (1, 1, 65535)))])
def test_launch_grid_takes_any_d(e, m, d, ff, grid):
    """The bf16 route's two grids (gate-up, down), computed without a
    card: any d, tiled over the grid's y, with the M-tile fastest."""
    assert TO.launch_grid(e, m, d, ff) == grid


@pytest.mark.parametrize("e,m,d,ff,grid", [
    (32, 320, 1024, 512, (10, 32, 1)),      # granite: one slab
    (16, 160, 4096, 6400, (5, 16, 4)),      # phi3.5-moe prefill
    (2, 40, 1100, 96, (2, 2, 2))])          # a ragged last slab
def test_launch_grid_f32_keeps_column_slabs(e, m, d, ff, grid):
    """f32 keeps the CUDA-core kernel: one grid over (M-tiles of 32,
    experts, slabs of at most 1024 of y's columns)."""
    assert TO.launch_grid(e, m, d, ff, torch.float32) == (grid,)


@pytest.mark.parametrize("e,m,ff,shape", [
    (32, 320, 512, (2, 32, 320, 512)), (2, 33, 70, (2, 2, 33, 128)),
    (16, 2, 6400, (2, 16, 2, 6400))])
def test_workspace_holds_h_pair_in_whole_tiles(e, m, ff, shape):
    """The bf16 workspace: h's hi and lo planes, rows of ff rounded up to
    whole 64-column tiles (so the down kernel's loads stay aligned)."""
    assert TO.workspace_shape(e, m, ff) == shape
    assert TO.tiles(16) == TO.TILES["decode"]
    assert TO.tiles(17) == TO.TILES["prefill"]


@pytest.mark.parametrize("e,m,d,ff,match", [
    (0, 8, 64, 64, "all > 0"), (4, 0, 64, 64, "all > 0"),
    (4, 8, 0, 64, "all > 0"), (4, 8, 64, 0, "all > 0"),
    (65536, 1, 8, 8, "at most 65535"),
    (1, 1, 65536 * 1024, 8, "at most 65535")])
def test_launch_grid_refuses_what_the_grid_cannot_hold(e, m, d, ff, match):
    with pytest.raises(ValueError, match=match):
        TO.launch_grid(e, m, d, ff)
    with pytest.raises(ValueError, match=match):
        TO.launch_grid(e, m, d, ff, torch.float32)


def test_jax_is_on_the_cpu():
    assert jax.default_backend() == "cpu"
