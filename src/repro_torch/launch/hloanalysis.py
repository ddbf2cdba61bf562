"""Op-trace analysis for the roofline: FLOPs, HBM bytes, per-kind
collective bytes and peak live memory of one step (PyTorch port of
``repro.launch.hloanalysis``, whose name it keeps).

The JAX package reads XLA's partitioned HLO text; the port has no
compiler to ask, so it analyses a recorded trace of aten ops instead.
``Recorder`` is a ``TorchDispatchMode``: each op a step dispatches is
recorded with the storages it reads and writes, and its FLOPs by
``torch.utils.flop_counter``'s formulas; each kernel a wrapper's analysis
route counts (``kernels.analysis``: inside a recorder, meta tensors
stand for the card's) is recorded as one op with the kernel's own
``work()``.  ``analyze`` then applies the JAX model of **perfect
fusion**: fusable ops (elementwise chains, reductions, creations, copies)
are coalesced into clusters by union-find, and HBM traffic is counted
only on edges that cross a cluster boundary or touch a material op
(matrix products, convolutions, scatters and index puts, sorts and
scans, the kernels, collectives, the step's arguments).  A view is free,
and a consumer reads only the view's region of its base; gathers and
index reads read their result's region and write it.  Unlike the JAX
model, the step's arguments are never written (they are in HBM), while
the final value of an argument the step updates in place, and every
output of the step, is written once.  It is an estimate, as the JAX one
is.

The recorder also keeps the live bytes of every storage (the arguments
given to ``arguments`` and everything the trace allocates, freed when
its last reference goes), so ``peak_bytes`` is the step's peak device
memory as the caching allocator would count it, before rounding.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import analysis

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d functional ops by name fragment -> their COLLECTIVES kind
_COLLECTIVE_OPS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
                   "reduce_scatter": "reduce-scatter",
                   "all_to_all": "all-to-all", "permute": "collective-permute"}
# aten ops that are never fused away: their operands and results hit HBM
MATERIAL = {
    "mm", "bmm", "addmm", "baddbmm", "_scaled_mm", "convolution",
    "convolution_backward", "_convolution", "scatter", "scatter_add",
    "scatter_reduce", "index_put", "_index_put_impl", "index_add",
    "index_copy", "masked_scatter", "embedding_dense_backward", "sort",
    "topk", "cumsum", "cumprod", "logcumsumexp", "_cdist_forward",
    "linalg_cholesky_ex", "triangular_solve", "_fft_r2c", "_fft_c2r",
    "_fft_c2c",
}
# consumers that read only their result-sized region of the operand
REGION_READERS = {"index", "gather", "index_select", "embedding", "take",
                  "masked_select", "_unsafe_index"}


def _base(name: str) -> str:
    """aten op name without its in-place suffix."""
    return name[:-1] if name.endswith("_") else name


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` holds: a broadcast (stride-0) dimension
    repeats the same elements, so an operand expanded for a batched
    product (``matmul`` folds or expands by strides, which meta and fake
    tensors may report apart) counts its elements once."""
    if t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


class _UF:
    def __init__(self):
        self.p: Dict[int, int] = {}

    def find(self, x: int) -> int:
        p = self.p
        while p.setdefault(x, x) != x:
            p[x] = p[p[x]]
            x = p[x]
        return x

    def union(self, a: int, b: int) -> None:
        self.p[self.find(a)] = self.find(b)


class Recorder(TorchDispatchMode):
    """Record a step's ops, kernels and storages (see the module).

    Use as a context manager around the step, after ``arguments``; then
    ``outputs`` with what the step returned, and ``analyze``."""

    def __init__(self):
        super().__init__()
        # node: (kind, name, operands [(value, read bytes)], flops)
        # kind: "arg", "op", "material", "region", "kernel", "collective"
        self.nodes: List[Tuple[str, str, list, float]] = []
        self.values: List[Tuple[int, int]] = []   # value -> (node, bytes)
        self.writer: Dict[int, int] = {}          # storage -> its value
        self.arg_storages: Dict[int, int] = {}    # storage -> arg value
        self.out_values: set = set()
        self.kernels: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"calls": 0, "launches": 0, "flops": 0.0, "bytes": 0.0})
        self.live: Dict[int, int] = {}            # storage -> bytes
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0

    # ---- storages ----------------------------------------------------
    def _free(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)
        self.writer.pop(key, None)
        self.arg_storages.pop(key, None)

    def _alloc(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self.live:
            n = st.nbytes()
            self.live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)
        return key

    def _value(self, node: int, t: torch.Tensor) -> int:
        self.values.append((node, _nbytes(t)))
        v = len(self.values) - 1
        self.writer[self._alloc(t)] = v
        return v

    def _operand(self, t: torch.Tensor) -> Tuple[int, int]:
        key = self._alloc(t)
        if key not in self.writer:                # made outside the trace
            node = self._node("arg", "argument", [], 0.0)
            self.values.append((node, t.untyped_storage().nbytes()))
            self.writer[key] = self.arg_storages[key] = len(self.values) - 1
        return self.writer[key], _nbytes(t)

    def _node(self, kind, name, operands, flops) -> int:
        self.nodes.append((kind, name, operands, flops))
        return len(self.nodes) - 1

    def arguments(self, tree) -> None:
        """Register the step's arguments (params, state, batch): they are
        live from the start and read from HBM."""
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                before = self.live_bytes
                self._operand(t)
                self.argument_bytes += self.live_bytes - before

    def outputs(self, tree) -> None:
        """Mark what the step returned: written once."""
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                self.out_values.add(self._operand(t)[0])

    # ---- recording ---------------------------------------------------
    def __enter__(self):
        super().__enter__()
        analysis._RECORDERS.append(self)
        return self

    def __exit__(self, *exc):
        analysis._RECORDERS.remove(self)
        return super().__exit__(*exc)

    def kernel(self, name, work, inputs, outputs, launches) -> None:
        """One call of a hand-written kernel (``kernels.analysis.record``)."""
        flops, nbytes = work
        k = self.kernels[name]
        k["calls"] += 1
        k["launches"] += launches
        k["flops"] += flops
        k["bytes"] += nbytes
        node = self._node("kernel", name,
                          [self._operand(t) for t in inputs], float(flops))
        for t in outputs:
            self._value(node, t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not func._schema.is_mutable and (func.is_view or not outs or {
                self._alloc(t) for t in outs} <= {self._alloc(t) for t in ins}):
            return out          # an alias, or a query of metadata: no traffic
        name = _base(func._overloadpacket.__name__)
        packet = func._overloadpacket
        flops = float(flop_registry[packet](*args, **kwargs, out_val=out)) \
            if packet in flop_registry else 0.0
        coll = next((kind for frag, kind in _COLLECTIVE_OPS.items()
                     if frag in name), None) \
            if "c10d" in func.namespace else None
        kind = ("collective" if coll else "material" if name in MATERIAL
                else "region" if name in REGION_READERS else "op")
        node = self._node(kind, coll or name,
                          [self._operand(t) for t in ins], flops)
        for t in outs:
            self._value(node, t)
        return out

    # ---- analysis ----------------------------------------------------
    def analyze(self) -> Dict[str, float]:
        """FLOPs, HBM bytes, collective bytes by kind, peak and argument
        bytes, and per-kernel calls, launches, FLOPs and bytes."""
        nodes, values = self.nodes, self.values
        fusable = lambda n: nodes[n][0] == "op"
        result = defaultdict(int)                 # node -> its results' bytes
        for node, nbytes in values:
            result[node] += nbytes
        uf = _UF()
        for i, (kind, _, operands, _) in enumerate(nodes):
            if kind != "op":
                continue
            for v, _ in operands:
                if fusable(values[v][0]):
                    uf.union(i, values[v][0])
        out = dict.fromkeys(COLLECTIVES, 0)
        hbm = 0
        written: set = set()              # values materialized in HBM
        read_edges: set = set()           # (value, consumer cluster)
        for i, (kind, name, operands, _) in enumerate(nodes):
            if kind == "collective":
                out[name] += result[i]
            if kind == "region":
                hbm += 2 * result[i]      # read the region, write it
                written.update(v for v, _ in operands)
                continue
            if kind == "arg":
                continue
            mine = uf.find(i) if kind == "op" else i
            for v, rb in operands:
                p = values[v][0]
                theirs = uf.find(p) if fusable(p) else p
                if theirs == mine:
                    continue              # fused edge: free
                written.add(v)
                if (v, mine) not in read_edges:
                    read_edges.add((v, mine))
                    hbm += rb             # the cluster reads it once
        # the step's outputs and its in-place updates of the arguments
        written.update(self.out_values)
        written.update(v for key, v in self.writer.items()
                       if key in self.arg_storages
                       and v != self.arg_storages[key])
        hbm += sum(values[v][1] for v in written
                   if nodes[values[v][0]][0] not in ("arg", "region"))
        out["collective_bytes"] = sum(out[k] for k in COLLECTIVES)
        out["hbm_bytes"] = hbm
        out["flops"] = sum(n[3] for n in nodes)
        out["kernel_flops"] = sum(n[3] for n in nodes if n[0] == "kernel")
        out["peak_bytes"] = self.peak_bytes
        out["argument_bytes"] = self.argument_bytes
        out["kernels"] = {k: dict(v) for k, v in self.kernels.items()}
        return out
