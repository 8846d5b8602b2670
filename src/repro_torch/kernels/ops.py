"""Public entry points of the port's kernels, named as in
``repro/kernels/ops.py``.

On the card there is no shape-based route to a plain version: the TPU
dispatch sent only tileable shapes (and, for flash attention, only calls
without positions; for the two scans, only T a multiple of the chunk) to
its kernels, while the Hopper kernels take every page size, sequence length
and window and every head_dim up to 256 that is a multiple of 4, every GEMM
shape (ragged M, K and N, no padding), and for the scans every T >= 1 (T = 1
included), any B up to 65535, any H or D, and a state width N up to 64
(wkv6) or 32 (selective_scan), whatever ``chunk`` is, and raise on anything
else. ``chunk`` only sets how many steps a scan kernel stages at a time.
A CPU tensor runs the plain version (see the wrappers).

Dtypes, as the TPU kernels take them: the paged kernels take q in fp32 or
bf16 over fp32, bf16 or int8 pools (latent pools fp32 or bf16) in any
pairing, flash attention q, k and v all fp32 or all bf16; each computes in
fp32 and returns q's dtype. The GEMMs take any float activations. The two
scans take fp32 only: ``repro``'s wkv6 callers upcast r, k, v, w and u
before the call (so does the port), its hymba casts every selective-scan
input to fp32, and both Pallas scans return fp32."""
from __future__ import annotations

import torch

from repro_torch.kernels import linear_scan as _ls
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.kernels.flash_attention import \
    flash_attention as _flash_attention
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_latent)


def _paged(q, pool_k, pool_v, block_tables, start, window, kind, mesh,
           shard_axis, k_scale=None, v_scale=None):
    """The paged dispatch: the rank's head slab under a tensor-parallel
    mesh (``mesh`` / ``shard_axis`` from ``specs.head_shard_axis``, as the
    reference routes them), else every head."""
    if mesh is not None and shard_axis is not None:
        return _pa.paged_attention_head_sharded(
            mesh, shard_axis, q, pool_k, pool_v, block_tables, start,
            window=window, kind=kind, k_scale=k_scale, v_scale=v_scale)
    return paged_attention(q, pool_k, pool_v, block_tables, start,
                           window=window, kind=kind, k_scale=k_scale,
                           v_scale=v_scale)


def paged_decode(q, pool_k, pool_v, block_tables, cache_pos, *,
                 window: int = 0, mesh=None, shard_axis=None):
    """Single-token decode attention against a paged KV cache.

    q: (B, 1, H, hd); pool_k/pool_v: (P, page_size, KV, hd), one layer's
    slice of the shared pool; block_tables: (B, mps) int32 (-1 =
    unallocated); cache_pos: (B,) int32 per-slot positions. The new K/V row
    must already be written at logical row cache_pos[b]. A freed slot
    (all--1 table) returns exactly 0. ``mesh`` / ``shard_axis`` (from
    ``specs.head_shard_axis``): the pools are this rank's kv-head slab and
    the result its (B, 1, H / tp, hd) query heads."""
    return _paged(q, pool_k, pool_v, block_tables, cache_pos, window,
                  "decode", mesh, shard_axis)


def paged_prefill(q, pool_k, pool_v, block_tables, start, *,
                  window: int = 0, mesh=None, shard_axis=None):
    """Prefill-chunk attention against a paged KV cache.

    q: (B, C, H, hd), row i of slot b at position ``start[b] + i``; the
    chunk's K/V rows must already be spliced into the slot's pages, so
    prior chunks, aliased prefix pages and the chunk itself are read
    uniformly through the block table. ``mesh`` / ``shard_axis`` as in
    :func:`paged_decode`."""
    return _paged(q, pool_k, pool_v, block_tables, start, window, "prefill",
                  mesh, shard_axis)


def _squeeze_scale(s):
    """A (P,) scale table, or the int8 backend's (P, 1) column taken as
    (P,): one whole-page group without tensor parallelism, and under it
    this rank's own group, the only one its slab of the pool holds."""
    if s is not None and s.dim() == 2:
        s = s[:, 0]
    return s


def paged_decode_q8(q, pool_k, pool_v, k_scale, v_scale, block_tables,
                    cache_pos, *, window: int = 0, mesh=None,
                    shard_axis=None):
    """:func:`paged_decode` over INT8 pools: pool_k/pool_v are int8 and
    k_scale/v_scale their (P,) or (P, 1) f32 per-page symmetric scales. The
    kernel dequantizes each page it gathers, so only int8 payload moves.
    Under ``mesh`` each rank dequantizes its slab with its own group's
    scale column."""
    return _paged(q, pool_k, pool_v, block_tables, cache_pos, window,
                  "decode_q8", mesh, shard_axis,
                  k_scale=_squeeze_scale(k_scale),
                  v_scale=_squeeze_scale(v_scale))


def paged_prefill_q8(q, pool_k, pool_v, k_scale, v_scale, block_tables,
                     start, *, window: int = 0, mesh=None, shard_axis=None):
    """:func:`paged_prefill` over INT8 pools (see paged_decode_q8)."""
    return _paged(q, pool_k, pool_v, block_tables, start, window,
                  "prefill_q8", mesh, shard_axis,
                  k_scale=_squeeze_scale(k_scale),
                  v_scale=_squeeze_scale(v_scale))


def _latent(q, pool_c, block_tables, start, scale_dim, d_v, kind, mesh,
            shard_axis):
    if mesh is not None and shard_axis is not None:
        return _pa.paged_attention_latent_head_sharded(
            mesh, shard_axis, q, pool_c, block_tables, start,
            scale_dim=scale_dim, d_v=d_v, kind=kind)
    return paged_attention_latent(q, pool_c, block_tables, start,
                                  scale_dim=scale_dim, d_v=d_v, kind=kind)


def paged_decode_latent(q, pool_c, block_tables, cache_pos, *,
                        scale_dim: int, d_v: int, mesh=None,
                        shard_axis=None):
    """Single-token decode attention over MLA latent pages. q: (B, 1, H,
    c+r) absorbed queries; pool_c: (P, page_size, 1, c+r), one latent row
    per token read once per page for both the scores and (its leading
    ``d_v`` columns) the values. Returns (B, 1, H, d_v) in latent space;
    the caller applies wkv_b's value half and ``wo``. The latent pool has
    no kv-head axis and stays whole on every rank; ``mesh`` /
    ``shard_axis`` (from ``specs.latent_head_shard_axis``) shard the
    absorbed queries and the output on their head axis."""
    return _latent(q, pool_c, block_tables, cache_pos, scale_dim, d_v,
                   "decode_latent", mesh, shard_axis)


def paged_prefill_latent(q, pool_c, block_tables, start, *, scale_dim: int,
                         d_v: int, mesh=None, shard_axis=None):
    """Prefill-chunk attention over MLA latent pages (see
    paged_decode_latent). q: (B, C, H, c+r); the chunk's latent rows must
    already be spliced into the slot's pages."""
    return _latent(q, pool_c, block_tables, start, scale_dim, d_v,
                   "prefill_latent", mesh, shard_axis)


def _check_row_positions(positions, n: int, name: str):
    """The kernel derives positions from row indices: positions given by a
    caller must be exactly 0..n-1 in every batch row."""
    want = torch.arange(n, device=positions.device)
    if positions.shape[-1] != n or not torch.equal(
            positions.long(), want.expand_as(positions)):
        raise ValueError(f"flash_attention takes {name} 0..{n - 1} only (the "
                         f"kernel derives positions from row indices)")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_positions=None, k_positions=None):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd): the
    full-sequence forward's attention. Positions are accepted for API
    parity with ``ref.flash_attention`` and must be the row indices."""
    if q_positions is not None:
        _check_row_positions(q_positions, q.shape[1], "q_positions")
    if k_positions is not None:
        _check_row_positions(k_positions, k.shape[1], "k_positions")
    return _flash_attention(q, k, v, causal=causal, window=window,
                            kind="forward")


def flash_prefill(q, k, v, *, causal: bool = True, window: int = 0):
    """K/V-exporting prefill attention: returns ``(O, K, V)`` where K and V
    are the input tensors themselves, the post-RoPE rows a serving prefill
    writes into its cache (the TPU export is a passthrough of its inputs,
    so no copy runs here either)."""
    return (_flash_attention(q, k, v, causal=causal, window=window,
                             kind="prefill"), k, v)


class _Matmul(torch.autograd.Function):
    """The systolic GEMM with its gradient: both gradient GEMMs (dX = g @
    W^T, dW = X^T @ g) go back through the same kernel, on transposed views
    (the kernel reads any strides), as ``repro``'s ``_matmul_vjp`` sends
    them through the Pallas kernel."""

    @staticmethod
    def forward(ctx, x, w, block_m, block_n, block_k, dataflow):
        ctx.save_for_backward(x, w)
        ctx.blocks = dict(block_m=block_m, block_n=block_n, block_k=block_k,
                          dataflow=dataflow)
        return _mm.matmul(x, w, **ctx.blocks)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm.matmul(g, w.t(), **ctx.blocks).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _mm.matmul(x.t(), g, **ctx.blocks).to(w.dtype)
        return dx, dw, None, None, None, None


def matmul(x, w, *, block_m: int = 128, block_n: int = 128,
           block_k: int = 128, dataflow: str = "output_stationary"):
    """Systolic tiled matmul x (M, K) @ w (K, N) -> (M, N), fp32
    accumulation, in the given dataflow. Differentiable: the backward runs
    both gradient GEMMs through the same kernel."""
    return _Matmul.apply(x, w, block_m, block_n, block_k, dataflow)


def quant_matmul(x, w_q, scales, *, block_m: int = 128, block_n: int = 128,
                 block_k: int = 128):
    """x (M, K) float times int8 w_q (K, N) with per-output-channel
    ``scales`` (N,), fp32 accumulation."""
    return _qm.quant_matmul(x, w_q, scales, block_m=block_m,
                            block_n=block_n, block_k=block_k)


def wkv6(r, k, v, w, u, s0, *, chunk: int = 32):
    """The RWKV6 wkv recurrence. r, k, v, w: (B, T, H, N); u: (H, N); s0:
    (B, H, N, N) -> (y (B, T, H, N), final state (B, H, N, N)), fp32."""
    return _ls.wkv6(r, k, v, w, u, s0, chunk=chunk)


def selective_scan(x, dt, b, c, a, h0, *, chunk: int = 64):
    """The mamba selective scan. x, dt: (B, T, D); b, c: (B, T, N); a:
    (D, N); h0: (B, D, N) -> (y (B, T, D), final state (B, D, N)), fp32."""
    return _ls.selective_scan(x, dt, b, c, a, h0, chunk=chunk)
