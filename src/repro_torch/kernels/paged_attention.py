"""Paged attention: block-table-indirect GQA attention over a shared fp32
KV page pool, for both serving shapes (decode Sq = 1, prefill chunk Sq = C).

On a CUDA tensor :func:`paged_attention` launches the hand-written Hopper
kernel in ``csrc/paged_attention.cu`` (it replaces the Pallas kernel
``repro/kernels/paged_attention.py::_kernel``) or raises; on a CPU tensor it
runs the plain version, ``kernels.ref.paged_attention``. There is no other
route and no fallback.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref

# kernel launches per caller ("decode", "prefill"): plain integers, raised
# by one exactly where the kernel is launched, so a run can show that its
# attention went through the kernel
LAUNCHES = {"decode": 0, "prefill": 0}

MAX_HEAD_DIM = 256


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib():
    from repro_torch.kernels import _build
    lib = _build.load("paged_attention")
    fn = lib.repro_paged_attention_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, pool_k, pool_v, block_tables, start):
    if q.dim() != 4 or pool_k.dim() != 4 or pool_k.shape != pool_v.shape:
        raise ValueError(f"paged_attention wants q (B,Sq,H,hd) and pools "
                         f"(P,ps,KV,hd); got {tuple(q.shape)}, "
                         f"{tuple(pool_k.shape)}, {tuple(pool_v.shape)}")
    B, Sq, H, hd = q.shape
    P, ps, KV, hd_p = pool_k.shape
    if hd_p != hd or H % KV:
        raise ValueError(f"head_dim {hd} vs pool {hd_p}, H={H} KV={KV}: "
                         f"H must be a multiple of KV and widths must match")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(start.shape) != (B,):
        raise ValueError(f"block_tables must be (B, mps) and start (B,) with "
                         f"B={B}; got {tuple(block_tables.shape)}, "
                         f"{tuple(start.shape)}")


def paged_attention(q, pool_k, pool_v, block_tables, start, *,
                    window: int = 0, kind: str = "decode"):
    """q: (B, Sq, H, hd) float32; pool_k/pool_v: (P, page_size, KV, hd)
    float32; block_tables: (B, mps) int32 page ids (-1 = unallocated);
    start: (B,) int32 position of each slot's first query row. Returns
    (B, Sq, H, hd) float32. ``kind`` names the caller whose launch count
    the kernel raises ('decode' or 'prefill')."""
    _check(q, pool_k, pool_v, block_tables, start)
    if kind not in LAUNCHES:
        raise ValueError(f"kind must be one of {sorted(LAUNCHES)}, got "
                         f"{kind!r}")
    tensors = (q, pool_k, pool_v, block_tables, start)
    if not q.is_cuda:
        if any(t.is_cuda for t in tensors):
            raise ValueError("paged_attention: all tensors must share q's "
                             "device")
        return ref.paged_attention(q, pool_k, pool_v, block_tables, start,
                                   window=window)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all tensors must share q's device")
    for name, t, dt in (("q", q, torch.float32),
                        ("pool_k", pool_k, torch.float32),
                        ("pool_v", pool_v, torch.float32),
                        ("block_tables", block_tables, torch.int32),
                        ("start", start, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"paged_attention: {name} must be {dt}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    B, Sq, H, hd = q.shape
    P, ps, KV, _ = pool_k.shape
    if hd > MAX_HEAD_DIM or hd % 4:
        raise ValueError(f"paged_attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM} and a multiple of 4, got {hd}")
    if any(t.data_ptr() % 16 for t in (q, pool_k, pool_v)):
        raise ValueError("paged_attention: q and pools must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                     block_tables.data_ptr(), start.data_ptr(),
                     out.data_ptr(), B, Sq, H, KV, hd, P, ps,
                     block_tables.shape[1], int(window),
                     1.0 / math.sqrt(hd), stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES[kind] += 1
    return out
