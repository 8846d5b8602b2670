"""Quantization (paper C5), the counterpart of ``repro/core/quantize.py``:
fp32 -> 16-bit fixed point (the paper's numeric scheme, emulated
bit-exactly), int8 per-channel post-training quantization of parameter
trees (the deployment path feeding the int8-weight GEMM), and the
symmetric int8 block quantization of one KV page.

Rounding matches the reference bit for bit: ``torch.round`` rounds half to
even as ``jnp.round`` does, and ``x / scale`` is a true f32 division, not a
multiplication by a reciprocal. Parameter trees are nested dicts, lists
and tuples of tensors; they are walked in JAX's flatten order (dict keys
sorted, sequences in order) and each leaf is named as JAX names it,
``"/".join(str(p) for p in path)`` (``['stages']/[0]/[0]/['conv1']/['w']``),
so a ``predicate`` written for the reference selects the same leaves here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional, Tuple

import torch


# ------------------------------------------------------------ tree walking
def _is_leaf(t) -> bool:
    """Anything but a dict, list or tuple (a QuantizedTensor included)."""
    return not isinstance(t, (dict, list, tuple))


def _flatten(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(name, leaf) pairs in JAX's flatten order; None is an empty subtree."""
    if tree is None:
        return
    if _is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], _join(path, f"[{k!r}]"))
    else:
        for i, v in enumerate(tree):
            yield from _flatten(v, _join(path, f"[{i}]"))


def _join(path: str, key: str) -> str:
    return f"{path}/{key}" if path else key


def _map(fn: Callable[[str, Any], Any], tree, path: str = ""):
    """The same nesting with every leaf replaced by ``fn(name, leaf)``,
    called in flatten order (dicts come back with sorted keys, as JAX
    rebuilds them)."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], _join(path, f"[{k!r}]"))
                for k in sorted(tree)}
    return type(tree)(_map(fn, v, _join(path, f"[{i}]"))
                      for i, v in enumerate(tree))


def _is_float_tensor(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


# ------------------------------------------------------- fixed point (paper)
def fixed_point(x, int_bits: int = 4, frac_bits: int = 11):
    """Round to signed 16-bit fixed point Q(int_bits).(frac_bits) (1 sign
    bit), clipping to its range. Tensil's 16-bit fixed default is
    Q4.11-like."""
    scale = 2.0 ** frac_bits
    lo = -(2.0 ** (int_bits + frac_bits))
    hi = 2.0 ** (int_bits + frac_bits) - 1
    q = torch.clamp(torch.round(x * scale), lo, hi)
    return q / scale


def fixed_point_tree(tree, int_bits: int = 4, frac_bits: int = 11):
    """:func:`fixed_point` on every floating leaf; other leaves as they are."""
    return _map(lambda _, t: fixed_point(t, int_bits, frac_bits)
                if _is_float_tensor(t) else t, tree)


# ------------------------------------------------------------- int8 PTQ
@dataclasses.dataclass
class QuantizedTensor:
    q: torch.Tensor          # int8
    scale: torch.Tensor      # per-channel (last dim) fp32, keepdims shape

    def dequant(self, dtype=torch.float32):
        return (self.q.float() * self.scale).to(dtype)


def page_scale(amax):
    """Symmetric int8 scale for a block whose max-abs is ``amax``: amax /
    127, or 1.0 for an all-zero block (a fresh page), whose payload is all
    zeros, so dequantizing returns exact zeros either way."""
    amax = torch.as_tensor(amax, dtype=torch.float32)
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def quantize_page(x, valid=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize one block to int8 with ONE symmetric scale. ``valid``
    optionally masks rows along the leading axis (a partial page): masked
    rows are left out of the amax and stored as 0. Returns ``(q int8,
    scale f32 scalar)``; dequant is ``q.float() * scale``."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if valid is not None:
        vm = torch.as_tensor(valid, dtype=torch.bool, device=x.device)
        x = torch.where(vm.reshape((-1,) + (1,) * (x.dim() - 1)), x, 0.0)
    scale = page_scale(x.abs().max())
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_per_channel(w, axis: int = -1) -> QuantizedTensor:
    """Symmetric int8 per-output-channel quantization along ``axis``; the
    scale keeps w's rank (size 1 on every other axis)."""
    axis %= w.dim()
    others = tuple(i for i in range(w.dim()) if i != axis)
    amax = w.abs().amax(dim=others, keepdim=True) if others else w.abs()
    scale = page_scale(amax)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale.to(torch.float32))


def quantize_params(params, *,
                    predicate: Optional[Callable[[str, Any], bool]] = None):
    """Quantize every >= 2-D floating leaf to int8 (per last-dim channel),
    and only those ``predicate(name, leaf)`` accepts when given. Returns the
    same nesting with the selected leaves as :class:`QuantizedTensor`."""
    def quant(name, leaf):
        ok = _is_float_tensor(leaf) and leaf.dim() >= 2
        if predicate is not None:
            ok = ok and predicate(name, leaf)
        return quantize_per_channel(leaf) if ok else leaf
    return _map(quant, params)


def dequantize_params(qparams, dtype=torch.bfloat16):
    """Every :class:`QuantizedTensor` leaf back to a ``dtype`` tensor."""
    return _map(lambda _, t: t.dequant(dtype)
                if isinstance(t, QuantizedTensor) else t, qparams)


def quantized_bytes(qparams) -> int:
    """Bytes of the tree: int8 payload plus f32 scales for quantized
    leaves, ``nbytes`` for the rest."""
    total = 0
    for _, leaf in _flatten(qparams):
        if isinstance(leaf, QuantizedTensor):
            total += leaf.q.numel() + leaf.scale.numel() * 4
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


# -------------------------------------------------------- activation calib
def calibrate_activation_scale(samples, percentile: float = 99.9):
    """Max-abs (clipped percentile) activation scale for static
    quantization: the k-th largest |sample|, k = the share above the
    percentile (at least 1), over 127."""
    a = samples.reshape(-1).abs()
    k = max(1, int(a.numel() * (1.0 - percentile / 100.0)))
    top = torch.topk(a, k).values[-1]
    return torch.clamp(top, min=1e-8) / 127.0


def quantization_error(params, qparams) -> dict:
    """Relative L2 error per quantized leaf, keyed by leaf name in the
    reference's order."""
    errs = {}
    for (name, w), (_, q) in zip(_flatten(params), _flatten(qparams)):
        if isinstance(q, QuantizedTensor):
            d = q.dequant()
            errs[name] = float(torch.linalg.norm(w - d)
                               / torch.clamp(torch.linalg.norm(w), min=1e-8))
    return errs
