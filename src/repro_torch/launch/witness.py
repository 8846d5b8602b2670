"""A float64 witness of the port's fp32 paths, for checks.

The port upcasts to fp32 wherever ``repro`` does (``Tensor.float()``,
``dtype=torch.float32``), so giving it float64 inputs still rounds every
such step to fp32. Inside ``float64()`` both name float64 instead, and the
same code, branch for branch, runs every step in float64. Two runs that
agree in fp32 only to the rounding of their sums (a sharded step against
a mesh-free one, say) then agree to float64's rounding, about 1e-14 of a
value; a difference that stays is the code's, not the rounding's.

The swap is process-wide and not thread-safe: use it in a process that
runs nothing else meanwhile (a test's rank, a check). Nothing in the port
calls it.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.tree import tree_map


@contextlib.contextmanager
def float64():
    """While active, ``torch.float32`` and ``Tensor.float`` mean float64."""
    saved = torch.float32, torch.Tensor.float
    torch.float32, torch.Tensor.float = torch.float64, torch.Tensor.double
    try:
        yield
    finally:
        torch.float32, torch.Tensor.float = saved


def to_float64(tree):
    """``tree`` with its floating leaves in float64, the others as they
    are."""
    return tree_map(lambda t: t.double() if t.is_floating_point() else t,
                    tree)
