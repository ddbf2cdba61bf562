"""Helpers of the audio (whisper-small) and VLM (llama-3.2-vision-11b)
parity tests: drawn CROSS_ATTN gates, seeded extras, and the decode
state's cross-attention leaves.

A freshly initialised CROSS_ATTN block is the identity: its ``gate_attn``
and ``gate_mlp`` start at 0 and tanh(0) = 0, so a check on such weights
cannot see the cross-attention, the image K/V or a lost image.  The
tests draw the gates from a seed (N(0, 1) per layer) in the numpy tree
that both packages are built from."""
import numpy as np

MULTIMODAL = ("whisper-small", "llama-3.2-vision-11b")
# decode-state leaves that hold the (static) encoder / image K/V
CROSS_KEYS = {"cross_attn": ("k", "v"), "encdec": ("xk", "xv")}


def draw_gates(npt, cfg, seed=5):
    """Give every CROSS_ATTN block of the numpy params tree ``npt``
    gates drawn from N(0, 1) (f32, one per layer), in place."""
    rng = np.random.default_rng(seed)
    for blk, kind in zip(npt["blocks"], cfg.period()):
        if kind == "cross_attn":
            for g in ("gate_attn", "gate_mlp"):
                blk[g] = rng.normal(size=blk[g].shape).astype(np.float32)
    return npt


def extras(cfg, batch, seed=6):
    """The batch's model extras as numpy f32: ``frames`` (B, enc_seq, d)
    for audio, ``img`` (B, n_img_tokens, d) for a VLM; {} otherwise."""
    if cfg.family not in ("audio", "vlm"):
        return {}
    key, n = (("frames", cfg.enc_seq) if cfg.family == "audio"
              else ("img", cfg.n_img_tokens))
    rng = np.random.default_rng(seed)
    return {key: rng.normal(size=(batch, n, cfg.d_model)).astype(np.float32)}


def with_cross(cfg, states, pre):
    """``states`` (decode states of either package) with their
    cross-attention leaves taken from the prefill states ``pre``."""
    return [{k: (p[k] if k in CROSS_KEYS.get(kind, ()) else v)
             for k, v in st.items()}
            for kind, st, p in zip(cfg.period(), states, pre)]
