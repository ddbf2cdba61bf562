"""Parameter/batch/state partition specs for the production meshes
(PyTorch port of ``repro.models.shardings``).

Rules are path-based and divisibility-aware: a dim is sharded over the
``model`` axis only when the logical structure allows it (e.g. KV-head
projections replicate when n_kv_heads < TP, as in MaxText); everything
else falls back to replication.

FSDP (ZeRO-3 style): when ``cfg.fsdp`` is set, the largest remaining
unsharded dim of every large param is additionally sharded over the
``data`` axis (within-pod only: cross-pod parameter gathering would ride
the slow inter-node links, so pods keep full replicas).

The port runs on one card and has no GSPMD to hand a spec to: a spec is
a plain tuple with one entry per dim, an axis name, a tuple of axis names
or None (the JAX package's ``PartitionSpec`` entries), and ``named``
pairs specs with their mesh.  The dry-run reads them to count per-device
bytes (``launch.dryrun``); ``make_train_step`` holds them against its
gradients and batch.
"""
from __future__ import annotations

import collections
import math
from typing import Optional, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.weights import tree_unflatten

NamedSharding = collections.namedtuple("NamedSharding", "mesh spec")


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def leaves_with_keys(tree, keys: Tuple[str, ...] = ()) -> list:
    """``(keys, leaf)`` of every tensor leaf in ``weights.tree_leaves``
    order; keys are the JAX paths' dict keys and list indices as strings
    (``repro.models.shardings._keys_of``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaves_with_keys(tree[k], keys + (str(k),))]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in leaves_with_keys(v, keys + (str(i),))]
    return [(keys, tree)]


def _logical_rule(keys: Tuple[str, ...], shape: Tuple[int, ...],
                  cfg: ArchConfig, tp: int) -> Tuple[Optional[str], ...]:
    """Spec entries for the *logical* (unstacked) param."""
    name = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else ""
    div = lambda n: n % tp == 0
    rep = (None,) * len(shape)

    if name == "embed":
        if div(cfg.vocab):
            return ("model", None)
        return (None, "model") if div(cfg.d_model) else rep
    if name == "lm_head":
        if div(cfg.vocab):
            return (None, "model")
        return ("model", None) if div(cfg.d_model) else rep

    # attention: shard the head dim when it divides TP; otherwise shard
    # the FLAT (H*hd) dim when that divides (llama3b 24H, whisper 12H,
    # GQA kv<16)
    if name in ("wq",) and parent in ("attn", "xattn"):
        return (None, "model") if (div(cfg.n_heads)
                                   or div(shape[-1])) else rep
    if name in ("wk", "wv") and parent in ("attn", "xattn"):
        return (None, "model") if (div(cfg.n_kv_heads)
                                   or div(shape[-1])) else rep
    if name == "wo" and parent in ("attn", "xattn"):
        return ("model", None) if (div(cfg.n_heads)
                                   or div(shape[0])) else rep

    # dense mlp
    if parent == "mlp" and name in ("w1", "w3"):
        return (None, "model") if div(shape[-1]) else rep
    if parent == "mlp" and name == "w2":
        return ("model", None) if div(shape[0]) else rep

    # MoE (expert parallelism over the model axis)
    if parent == "moe" and name in ("w1", "w2", "w3"):
        return ("model", None, None) if div(cfg.n_experts) else rep
    if parent == "moe" and name == "router":
        return rep

    # Mamba2
    if parent == "mamba":
        d_inner = cfg.ssm_expand * cfg.d_model
        h = d_inner // cfg.ssm_headdim
        if name in ("in_z", "in_x"):
            return (None, "model") if div(d_inner) else rep
        if name == "in_dt":
            return (None, "model") if div(h) else rep
        if name == "conv_x":
            return (None, "model") if div(d_inner) else rep
        if name in ("dt_bias", "a_log", "d_skip"):
            return ("model",) if div(h) else rep
        if name == "norm_w":
            return ("model",) if div(d_inner) else rep
        if name == "out_proj":
            return ("model", None) if div(d_inner) else rep
        return rep                      # in_b/in_c/conv_b/conv_c

    # mLSTM
    if parent == "mlstm":
        du = int(cfg.xlstm_proj_factor * cfg.d_model)
        hd = du // cfg.n_heads
        if name in ("up_x", "up_z", "conv_w"):
            return (None, "model") if div(du) else rep
        if name in ("wq", "wk"):
            # shard on hd_k: score matrices reduce (B,q,q,H: small)
            # instead of gathering (B,S,H,hd) activations per chunk
            return (None, None, "model") if div(hd) else rep
        if name == "wv":
            return (None, None, "model") if div(hd) else rep
        if name in ("skip", "norm_w"):
            return ("model",) if div(du) else rep
        if name == "down":
            return ("model", None) if div(du) else rep
        return rep                      # wi/wf/bi/bf

    # sLSTM: scanned recurrence, small: replicate
    return rep


def _with_fsdp(spec: Tuple[Optional[str], ...], shape: Tuple[int, ...],
               dp: int, min_size: int = 2 ** 16) -> Tuple[Optional[str], ...]:
    """Shard the largest unsharded dim over 'data' if divisible."""
    if math.prod(shape) < min_size or "data" in spec:
        return spec
    best, best_dim = None, 0
    for i, (s, d) in enumerate(zip(spec, shape)):
        if s is None and d % dp == 0 and d > best_dim:
            best, best_dim = i, d
    if best is None:
        return spec
    out = list(spec)
    out[best] = "data"
    return tuple(out)


def param_pspecs(cfg: ArchConfig, param_shapes, mesh):
    """Tree of specs matching the params' structure."""
    tp = mesh.shape.get("model", 1)
    dp = mesh.shape.get("data", 1)
    specs = []
    for keys, leaf in leaves_with_keys(param_shapes):
        stacked = keys[0] in ("blocks", "encoder")
        shape = tuple(leaf.shape)
        spec = _logical_rule(keys, shape[1:] if stacked else shape, cfg, tp)
        if stacked:
            spec = (None,) + spec
        if cfg.fsdp and dp > 1:
            spec = _with_fsdp(spec, shape, dp)
        specs.append(spec)
    return tree_unflatten(param_shapes, specs)


def state_pspecs(cfg: ArchConfig, state_shapes, mesh):
    """Train-state specs.

    Optimizer moments additionally shard over ``data`` (ZeRO-1): unlike
    FSDP'd *weights* they are touched once per step at the update, so
    there is no per-layer gather; the update itself runs sharded and new
    params all-gather once.  The step (a host int in the port) is ()."""
    pspecs = param_pspecs(cfg, state_shapes["params"], mesh)
    dp = mesh.shape.get("data", 1)
    opt_specs = []
    for spec, (_, leaf) in zip(spec_leaves(pspecs),
                               leaves_with_keys(state_shapes["params"])):
        full = spec + (None,) * (leaf.dim() - len(spec))
        opt_specs.append(_with_fsdp(full, tuple(leaf.shape), dp)
                         if dp > 1 else spec)
    ospecs = tree_unflatten(state_shapes["params"], opt_specs)
    return {"params": pspecs,
            "opt": {"m": ospecs, "v": ospecs, "step": ()}}


def spec_leaves(specs) -> list:
    """The specs of a spec tree (tuples are leaves), in tree order."""
    if specs is None:
        return []
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [specs]


def _dp_if_divisible(mesh, batch: int):
    """The dp axes a batch dim shards over, as a ``PartitionSpec`` entry:
    a tuple of two or more names, one name, or None."""
    dpx = dp_axes(mesh)
    n = math.prod(mesh.shape[a] for a in dpx)
    if n <= 1 or batch % n:
        return None
    return dpx if len(dpx) > 1 else dpx[0]


def batch_pspecs(cfg: ArchConfig, batch_shapes, mesh):
    return {k: (_dp_if_divisible(mesh, v.shape[0]),) + (None,) * (v.dim() - 1)
            for k, v in batch_shapes.items()}


def decode_state_pspecs(cfg: ArchConfig, state_shapes, mesh):
    """Specs for stacked decode states (leading dim = n_periods).

    KV caches shard batch over dp and kv-heads over model when divisible;
    with kv < TP the cache *sequence* dim shards over model instead
    (flash-decoding style). SSM/xLSTM states shard their head/value dims
    over model.
    """
    tp = mesh.shape.get("model", 1)
    d_inner = cfg.ssm_expand * cfg.d_model if cfg.ssm_state else 0
    ssm_h = d_inner // cfg.ssm_headdim if cfg.ssm_state else 0
    du = int(cfg.xlstm_proj_factor * cfg.d_model)
    mhd = du // cfg.n_heads

    def leaf_spec(keys, leaf):
        name = keys[-1]
        nd = leaf.dim()
        dpx = _dp_if_divisible(mesh, leaf.shape[1])
        if name in ("k", "v", "xk", "xv"):       # (P,B,S,kv,hd)
            if cfg.n_kv_heads % tp == 0:
                return (None, dpx, None, "model", None)
            if leaf.shape[2] % tp == 0:          # shard cache sequence
                return (None, dpx, "model", None, None)
            return (None, dpx, None, None, None)
        if name == "ssm":                        # (P,B,H,Pd,N)
            h_ax = "model" if ssm_h and ssm_h % tp == 0 else None
            return (None, dpx, h_ax, None, None)
        if name == "conv_x":                     # (P,B,K,d_inner)
            ax = "model" if d_inner and d_inner % tp == 0 else None
            return (None, dpx, None, ax)
        if name in ("conv_b", "conv_c"):
            return (None, dpx, None, None)
        if name == "c" and nd == 5:              # (P,B,H,hdv,hdk)
            ax = "model" if mhd % tp == 0 else None
            return (None, dpx, None, ax, None)
        if name == "conv" and nd == 4:           # (P,B,K,du)
            ax = "model" if du % tp == 0 else None
            return (None, dpx, None, ax)
        # n (P,B,H,hdk), m (P,B,H), slstm states (P,B,d)
        return (None, dpx) + (None,) * (nd - 2)

    return tree_unflatten(state_shapes, [
        leaf_spec(k, leaf) for k, leaf in leaves_with_keys(state_shapes)])


def named(mesh, spec_tree):
    """Each spec of ``spec_tree`` paired with ``mesh``."""
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [named(mesh, v) for v in spec_tree]
    return None if spec_tree is None else NamedSharding(mesh, spec_tree)
