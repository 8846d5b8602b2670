"""Roofline inputs of an eager step, the counterpart of
``repro/launch/hlo_stats.py``. PyTorch runs eagerly, so there is no HLO
here: every count comes from the ops dispatched while the step runs
(``OpCounter``, ``LiveBytes``, both ``TorchDispatchMode``s) and from the
port's own collective functions (``collectives``). They count the same on
real tensors and on fake ones, so a step can be counted at full size
without the memory it would take.

  * ``cost_stats``: FLOPs and bytes of every op (``OpCounter``);
  * ``memory_stats``: ``repro``'s five memory keys, read from the live
    tensor storages (``LiveBytes``);
  * ``collective_bytes``: per-rank bytes per collective kind, by
    ``repro``'s rule, from the records of ``sharding/specs.py``'s
    ``all_gather`` / ``reduce_scatter`` / ``all_reduce`` / ``shift``.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}


def shape_bytes(dtype: str, dims: str) -> int:
    """Bytes of an array given as an HLO dtype name and comma-separated
    dims ("f32", "8,128")."""
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


# ------------------------------------------------------------------ cost
# ops XLA's HloCostAnalysis counts as transcendentals, not flops
_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh",
    "sigmoid", "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "sinh",
    "cosh", "erf", "erfc", "erfinv", "rsqrt", "sqrt", "pow", "logit",
    "lgamma", "digamma"})
# pointwise-tagged ops that move data and compute nothing
_MOVES = frozenset({"clone", "copy", "_to_copy", "fill", "zero",
                    "masked_fill", "lift_fresh_copy", "detach_copy"})
# reductions: one flop per input element, as XLA's reduce counts its
# computation once per element it folds in
_REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "cumsum", "var",
    "std", "norm", "linalg_vector_norm", "topk"})
# fused eager ops: flops per input element of the ops XLA runs for them
# (softmax: max-reduce, subtract, sum-reduce, divide; the exp and log are
# transcendentals)
_FUSED = {"_softmax": 4, "_log_softmax": 4, "_softmax_backward_data": 4,
          "_log_softmax_backward_data": 4, "logsumexp": 3}


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


def _first_tensor(args):
    for a in tree_leaves(args):
        if isinstance(a, torch.Tensor):
            return a
    return None


class OpCounter(TorchDispatchMode):
    """Counts every aten op dispatched while active (backward included).

    ``dot_flops``: each matrix product and convolution at 2 per
    multiply-add, by ``torch.utils.flop_counter``'s formulas (``by_op``
    keeps them per op name). An einsum that contracts nothing (an outer
    product, rwkv6's k v^T) runs as ``mul`` and is counted as one, where
    a jaxpr holds a ``dot_general``. ``flops``: ``dot_flops`` plus one per
    output element of every other floating-point arithmetic op, as XLA's
    ``HloCostAnalysis`` counts elementwise ops (a reduction one per input
    element; softmax, log-softmax and logsumexp by the ops XLA runs for
    them); transcendentals and copies are not counted. ``bytes``: every
    op's input and output bytes, views excepted. That is the unfused
    count: an op reads its inputs from memory and writes its output
    there, where XLA's fusions keep intermediates in registers, so XLA's
    fused count is lower."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._dots = flop_registry
        self.flops = 0
        self.dot_flops = 0
        self.bytes = 0
        self.by_op: Dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out
        packet = func.overloadpacket
        name = packet.__name__
        if packet in self._dots:
            n = int(self._dots[packet](*args, **kwargs, out_val=out))
            self.dot_flops += n
            self.flops += n
            self.by_op[name] += n
        elif name in _FUSED:
            self.flops += _FUSED[name] * _numel(_first_tensor(args))
        elif name in _REDUCTIONS:
            x = _first_tensor(args)
            if x is not None and x.is_floating_point():
                self.flops += x.numel()
        elif (torch.Tag.pointwise in func.tags
              and name.rstrip("_") not in _TRANSCENDENTAL
              and name.rstrip("_") not in _MOVES):
            y = _first_tensor(out)
            if y is not None and y.is_floating_point():
                self.flops += y.numel()
        if not func.is_view:
            self.bytes += sum(_tensor_bytes(t) for t in tree_leaves(
                (args, kwargs, out)) if isinstance(t, torch.Tensor))
        return out


def cost_stats(counter: OpCounter) -> Dict[str, float]:
    """``repro``'s cost keys from an :class:`OpCounter`, plus
    ``dot_flops``."""
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "dot_flops": float(counter.dot_flops)}


# ---------------------------------------------------------------- memory
class OverBudget(RuntimeError):
    """Raised by :class:`LiveBytes` when its live bytes pass its limit."""


def _storage(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.untyped_storage()


class LiveBytes(TorchDispatchMode):
    """Tracks the tensor storages alive while a step runs: those of its
    arguments (``arguments``), and every storage an op creates while the
    mode is active, each counted from its creation until it is freed. The
    peak is the most bytes alive at once. With ``limit``, an op that takes
    the live bytes past it raises :class:`OverBudget` (a step that cannot
    fit stops early)."""

    def __init__(self, limit=None):
        super().__init__()
        self.limit = limit
        self.live = 0
        self.peak = 0
        self._ids = set()           # ids of the storages counted now
        self._args = {}             # id -> nbytes of the arguments'
        self._outs = None

    def _add(self, st) -> bool:
        key = id(st)
        if key in self._ids:
            return False
        self._ids.add(key)
        n = st.nbytes()
        self.live += n
        weakref.finalize(st, self._free, key, n)
        if self.live > self.peak:
            self.peak = self.live
            if self.limit is not None and self.peak > self.limit:
                raise OverBudget(f"{self.peak} bytes alive > {self.limit}")
        return True

    def _free(self, key, n):
        self._ids.discard(key)
        self.live -= n

    def arguments(self, tree):
        """Count ``tree``'s storages as the step's arguments (alive from
        the start)."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                st = _storage(t)
                self._add(st)
                self._args[id(st)] = st.nbytes()

    def outputs(self, tree):
        """Record ``tree`` as the step's outputs (after it returned)."""
        seen = {}
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                st = _storage(t)
                seen[id(st)] = st.nbytes()
        self._outs = seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t.untyped_storage())
        return out


def memory_stats(tracker: LiveBytes) -> Dict[str, int]:
    """``repro``'s five memory keys from a :class:`LiveBytes` that saw the
    step's arguments and outputs:

    * ``argument_bytes``: the step's inputs on this rank;
    * ``output_bytes``: its outputs;
    * ``alias_bytes``: the outputs that are an input's storage (a cache or
      a state updated in place);
    * ``temp_bytes``: the peak above the arguments and the outputs that
      are not aliases (XLA's temporaries: what the step holds beyond the
      buffers it reads and writes), so argument + temp + output - alias is
      the peak;
    * ``code_bytes``: 0. Eager PyTorch loads no program of its own per
      step: the kernels it launches are part of the library (and of the
      port's kernel builds), not of the step.
    """
    outs = tracker._outs or {}
    arg = sum(tracker._args.values())
    out = sum(outs.values())
    alias = sum(n for k, n in outs.items() if k in tracker._args)
    return {"argument_bytes": arg, "output_bytes": out,
            "temp_bytes": max(0, tracker.peak - arg - out + alias),
            "alias_bytes": alias, "code_bytes": 0}


# ------------------------------------------------------------ collectives
_KINDS = ("all-gather", "reduce-scatter", "all-reduce", "collective-permute")


@contextlib.contextmanager
def collectives():
    """Record, while active, every collective that ``sharding/specs.py``'s
    ``all_gather``, ``reduce_scatter``, ``all_reduce`` and ``shift`` run:
    yields the list their (kind, result bytes, group size) records are
    appended to."""
    from repro_torch.sharding import specs
    records: list = []
    token = specs.COLLECTIVES.set(records)
    try:
        yield records
    finally:
        specs.COLLECTIVES.reset(token)


def collective_bytes(records: Iterable) -> Dict[str, int]:
    """PER-RANK bytes per collective kind, ``repro``'s rule:

      all-gather         : the result's bytes (what a rank receives)
      reduce-scatter     : the operand's bytes = the result's times the group
      all-reduce         : the result's bytes
      collective-permute : the result's bytes (= the operand's)

    plus ``total``, their sum. Every kind that ran has a key."""
    out: Dict[str, int] = defaultdict(int)
    for kind, nbytes, group in records:
        if kind not in _KINDS:
            raise ValueError(f"unknown collective {kind!r}")
        out[kind] += nbytes * (group if kind == "reduce-scatter" else 1)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return dict(out)
