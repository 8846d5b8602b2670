"""Serving step builders, as in ``repro/launch/steps.py``. PyTorch runs
eagerly, so a builder returns a plain function where ``repro`` returned one
to be jitted."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.registry import Model


def make_prefill_chunk_paged(model: Model, *, compute_dtype=torch.float32,
                             attn_impl: str = "kernel"):
    """Incremental paged prefill: returns ``chunk(params, cache, batch) ->
    (last_logits, cache)``. ``batch`` carries ``tokens`` (K, C), ``bt``
    (K, mps) block-table rows, ``start`` (the chunk's first absolute
    position, shared by the group) and ``floor`` (the first row the group
    may write). The chunk's K/V land in the resident pools in place."""
    def chunk(params, cache, batch):
        return model.prefill_chunk_paged(
            params, batch["tokens"], cache, bt_rows=batch["bt"],
            start=batch["start"], write_floor=batch["floor"],
            compute_dtype=compute_dtype, attn_impl=attn_impl)
    return chunk


def make_decode_step(model: Model, *, compute_dtype=torch.float32,
                     paged_attn_impl: Optional[str] = None):
    """One-token decode against the paged cache, updated in place.
    ``paged_attn_impl`` ('kernel' | 'einsum') selects the paged read path;
    None keeps the model's default (the masked-einsum reference)."""
    extra = {}
    if paged_attn_impl is not None:
        extra["paged_attn_impl"] = paged_attn_impl

    def decode(params, cache, batch):
        return model.decode_step(params, batch["token"], cache,
                                 compute_dtype=compute_dtype, **extra)
    return decode
