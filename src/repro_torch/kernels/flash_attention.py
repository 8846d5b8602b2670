"""Flash attention: blockwise causal / windowed GQA attention over
contiguous K/V, for the full-sequence forward and a serving prefill's
first chunk. q, k and v are all fp32 or all bf16; the kernel computes in
fp32 and returns q's dtype, as the Pallas kernel does.

On a CUDA tensor :func:`flash_attention` launches the hand-written Hopper
kernel in ``csrc/flash_attention.cu`` (it replaces the Pallas kernel
``repro/kernels/flash_attention.py::_kernel``) or raises; on a CPU tensor it
runs the plain version, ``kernels.ref.flash_attention``. There is no other
route and no fallback.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

# kernel launches per caller ("prefill": ops.flash_prefill, "forward":
# ops.flash_attention) and dtype (bf16 operands add "_bf16"): plain
# integers, raised by one exactly where the kernel is launched
KINDS = ("prefill", "forward")
_DT = {torch.float32: "", torch.bfloat16: "_bf16"}
LAUNCHES = {kind + tag: 0 for kind in KINDS for tag in _DT.values()}

MAX_HEAD_DIM = 256


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib(dtype):
    lib = _build.load("flash_attention")
    fn = getattr(lib, "repro_flash_attention_"
                 + ("bf16" if dtype == torch.bfloat16 else "f32"))
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q (B,Sq,H,hd) and k, v "
                         f"(B,Sk,KV,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Bk, Sk, KV, hd_k = k.shape
    if Bk != B or hd_k != hd or H % KV:
        raise ValueError(f"q {tuple(q.shape)} vs k {tuple(k.shape)}: batch "
                         f"and head_dim must match and H a multiple of KV")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kind: str = "forward"):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); all float32 or all
    bfloat16. Query row i and key row j sit at positions i and j. Returns
    (B, Sq, H, hd) in q's dtype, computed in fp32. ``kind`` names the
    caller whose launch count the kernel raises ('forward' or 'prefill';
    the key adds "_bf16" for bf16 operands)."""
    _check(q, k, v)
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {list(KINDS)}, got {kind!r}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not q.is_cuda:
        if k.is_cuda or v.is_cuda:
            raise ValueError("flash_attention: all tensors must share q's "
                             "device")
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: all tensors must share q's device")
    if q.dtype not in _DT:
        raise TypeError(f"flash_attention: q must be torch.float32 or "
                        f"torch.bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} must be {q.dtype} as "
                            f"q is, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             f"aligned")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM or hd % 4:
        raise ValueError(f"flash_attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM} and a multiple of 4, got {hd}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), B, Sq, Sk, H, KV, hd, int(bool(causal)),
                     int(window), _build.SMS, 1.0 / math.sqrt(hd), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES[kind + _DT[q.dtype]] += 1
    return out
