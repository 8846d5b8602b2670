"""Public entry points of the port's kernels, named as in
``repro/kernels/ops.py``.

On the card there is no shape-based route to a plain version: the TPU
dispatch sent only (8, 128)-tileable shapes to its kernel, while the Hopper
kernel takes every page size and every head_dim up to 256 and raises on
anything else. A CPU tensor runs the plain version (see the wrapper)."""
from __future__ import annotations

from repro_torch.kernels.paged_attention import paged_attention


def paged_decode(q, pool_k, pool_v, block_tables, cache_pos, *,
                 window: int = 0):
    """Single-token decode attention against a paged KV cache.

    q: (B, 1, H, hd); pool_k/pool_v: (P, page_size, KV, hd), one layer's
    slice of the shared pool; block_tables: (B, mps) int32 (-1 =
    unallocated); cache_pos: (B,) int32 per-slot positions. The new K/V row
    must already be written at logical row cache_pos[b]. A freed slot
    (all--1 table) returns exactly 0."""
    return paged_attention(q, pool_k, pool_v, block_tables, cache_pos,
                           window=window, kind="decode")


def paged_prefill(q, pool_k, pool_v, block_tables, start, *,
                  window: int = 0):
    """Prefill-chunk attention against a paged KV cache.

    q: (B, C, H, hd), row i of slot b at position ``start[b] + i``; the
    chunk's K/V rows must already be spliced into the slot's pages, so
    prior chunks, aliased prefix pages and the chunk itself are read
    uniformly through the block table."""
    return paged_attention(q, pool_k, pool_v, block_tables, start,
                           window=window, kind="prefill")
