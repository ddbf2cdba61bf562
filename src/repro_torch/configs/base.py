"""Architecture + run configuration dataclasses (PyTorch port).

Field-for-field copy of ``repro.configs.base``: every assigned
architecture gets one file in this package defining an ``ArchConfig``;
``registry.py`` resolves ``--arch <id>`` strings.  The copy exists because
the JAX package's module imports ``jax.numpy`` for ``param_dtype()``; here
``torch_dtype()`` takes its place.  ``use_pallas_kernels`` is kept so the
two packages' configs compare equal, but the port dispatches attention by
the tensor's device, not by this flag.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


# ---------------------------------------------------------------------------
# Block kinds making up the unified stack.
# ---------------------------------------------------------------------------
ATTN = "attn"            # GQA attention + MLP (dense transformer block)
MOE = "moe"              # GQA attention + MoE FFN
MAMBA = "mamba"          # Mamba2 SSM block
SHARED_ATTN = "shared_attn"  # zamba2: shared-weight attention block
MLSTM = "mlstm"          # xLSTM matrix-memory block
SLSTM = "slstm"          # xLSTM scalar-memory block
CROSS_ATTN = "cross_attn"    # vlm: cross-attention to image embeddings + MLP
ENCDEC = "encdec"        # audio decoder block: self-attn + cross-attn + MLP


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Unified architecture description for the model zoo."""

    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden size (defaults to d_ff)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM / hybrid ---
    ssm_state: int = 0               # Mamba2 state dimension N
    ssm_expand: int = 2              # Mamba2 expansion factor
    ssm_headdim: int = 64            # Mamba2 head dim P
    ssm_chunk: int = 256             # chunked-scan chunk length
    shared_attn_every: int = 0       # zamba2: shared attn block period

    # --- xLSTM ---
    slstm_every: int = 0             # 1-in-k blocks are sLSTM (xLSTM[7:1] -> 8)
    xlstm_proj_factor: float = 2.0   # mLSTM up-projection factor

    # --- encoder-decoder (audio) ---
    n_enc_layers: int = 0
    enc_seq: int = 0                 # stub frontend: frames provided pre-embedded

    # --- VLM ---
    cross_attn_every: int = 0        # a cross-attn layer every k layers
    n_img_tokens: int = 0            # stub vision tower output length

    # --- common ---
    head_dim: int = 0                # 0 -> d_model // n_heads
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    act: str = "silu"                # silu (SwiGLU) | gelu
    tie_embeddings: bool = False
    window: int = 0                  # sliding-window attention (0 = full)
    dtype: str = "bfloat16"

    # --- runtime/dist knobs (kept for parity with the JAX package) ---
    remat: bool = True
    scan_layers: bool = True
    fsdp: bool = False
    use_pallas_kernels: bool = False
    sequence_parallel: bool = False
    deploy: bool = False
    bf16_tp_reduce: bool = False

    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---- block layout -----------------------------------------------------
    def block_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind for the decoder stack."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "moe":
                kinds.append(MOE)
            elif self.family == "hybrid":
                if self.shared_attn_every and (i % self.shared_attn_every
                                               == self.shared_attn_every - 1):
                    kinds.append(SHARED_ATTN)
                else:
                    kinds.append(MAMBA)
            elif self.family == "ssm":
                if self.slstm_every and i % self.slstm_every == 0:
                    kinds.append(SLSTM)
                else:
                    kinds.append(MLSTM)
            elif self.family == "vlm":
                if self.cross_attn_every and (i % self.cross_attn_every
                                              == self.cross_attn_every - 1):
                    kinds.append(CROSS_ATTN)
                else:
                    kinds.append(ATTN)
            elif self.family == "audio":
                kinds.append(ENCDEC)
            else:  # dense
                kinds.append(ATTN)
        return tuple(kinds)

    def period(self) -> Tuple[str, ...]:
        """Block-kind pattern of one super-block period.

        The stack is ``n_periods`` repetitions of this pattern; params are
        stacked per period position (a leading ``n_per`` axis).
        """
        kinds = self.block_kinds()
        if self.family == "hybrid" and self.shared_attn_every:
            p = self.shared_attn_every
        elif self.family == "ssm" and self.slstm_every:
            p = self.slstm_every
        elif self.family == "vlm" and self.cross_attn_every:
            p = self.cross_attn_every
        else:
            p = 1
        assert self.n_layers % p == 0, (self.name, self.n_layers, p)
        pat = kinds[:p]
        assert kinds == pat * (self.n_layers // p)
        return pat

    def n_periods(self) -> int:
        return self.n_layers // len(self.period())

    def is_subquadratic(self) -> bool:
        """Can this arch run the 500k-token long-context decode shape?"""
        return self.family in ("ssm", "hybrid")

    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_params(self) -> int:
        """Total parameter count (matches init exactly)."""
        from repro_torch.models.model import count_params  # avoids cycle
        return count_params(self)


# ---------------------------------------------------------------------------
# Input shapes (assigned): every LM arch is paired with all four.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs; reason when skipped."""
    if shape.name == "long_500k" and not cfg.is_subquadratic():
        return False, ("pure full-attention arch: 500k dense KV decode is "
                       "super-linear in state; skipped per DESIGN.md "
                       "SS4 shape-skips")
    return True, ""
