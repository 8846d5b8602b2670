"""The int8-weight GEMM of the paper's quantization contribution (C5):
float activations times int8 weights with one f32 scale per output
channel, fp32 accumulation. The weights stay int8 in device memory and are
dequantized in the tile, right before the multiply.

On a CUDA tensor :func:`quant_matmul` launches the hand-written Hopper
kernel in ``csrc/matmul.cu`` (``repro_quant_matmul``; it replaces the
Pallas kernel ``repro/kernels/quant_matmul.py::_kernel``) or raises; on a
CPU tensor it runs the plain version ``ref.quant_matmul``. There is no
other route and no fallback. It runs K7's output-stationary schedule
(``matmul.tile_plan``), with the weight staged as int8 and dequantized
into the block's resident f32 tile (the skinny schedule at M <= 16:
dequantized as it is read), or K7's split or wide schedule where the shape
takes one, so that it gives K7's bits on the dequantized weight.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.matmul import (check_operands, launch_geometry,
                                        plan_for, scratch)

# kernel launches: a plain integer, raised by one exactly where the kernel
# is launched
LAUNCHES = {"quant_matmul": 0}

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_void_p])


def reset_launches():
    LAUNCHES["quant_matmul"] = 0


def _lib():
    from repro_torch.kernels import _build
    fn = _build.load("matmul").repro_quant_matmul
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def quant_matmul(x, w_q, scales, *, block_m: int = 128, block_n: int = 128,
                 block_k: int = 128):
    """x: (M, K) float; w_q: (K, N) int8; scales: (N,) -> (M, N) in x's
    dtype. On the card x is float32 or bfloat16 and scales float32; the
    kernel's tile is ``matmul.tile_plan``'s whatever the (reference's)
    block sizes."""
    check_operands("quant_matmul", x, w_q)
    N = w_q.shape[1]
    if tuple(scales.shape) != (N,):
        raise AssertionError((tuple(w_q.shape), tuple(scales.shape)))
    if min(block_m, block_n, block_k) < 1:
        raise ValueError(f"block sizes must be >= 1, got "
                         f"{(block_m, block_n, block_k)}")
    if not x.is_cuda:
        if scales.is_cuda:
            raise ValueError("quant_matmul: all tensors must share x's "
                             "device")
        return ref.quant_matmul(x, w_q, scales)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quant_matmul kernel takes float32 or bfloat16 x, "
                        f"got {x.dtype}")
    if w_q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"quant_matmul kernel takes int8 w_q and float32 "
                        f"scales, got {w_q.dtype} and {scales.dtype}")
    if scales.device != x.device or not scales.is_contiguous():
        raise ValueError("quant_matmul: scales must be contiguous on x's "
                         "device")
    geometry = launch_geometry(x, w_q)
    M = geometry[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    plan = plan_for(x, w_q, geometry)
    part = scratch(plan, M, N, "output_stationary", x.dtype, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib()(x.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
                     None if part is None else part.data_ptr(),
                     out.data_ptr(), *geometry,
                     int(x.dtype == torch.bfloat16), *plan.c_args(), stream)
    if err:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["quant_matmul"] += 1
    return out
