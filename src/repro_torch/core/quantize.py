"""Symmetric int8 quantization of one block, the KV page: the counterpart
of ``page_scale`` and ``quantize_page`` in ``repro/core/quantize.py``.

Rounding matches the reference bit for bit: ``torch.round`` rounds half to
even as ``jnp.round`` does, and ``x / scale`` is a true f32 division, not a
multiplication by a reciprocal. The rest of that module (fixed point,
per-channel weight quantization) belongs to the paper's pipeline and is
not ported yet (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

from typing import Tuple

import torch


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
