"""The systolic tiled GEMM: out = x @ w with fp32 accumulation, in the
output-, weight- or input-stationary dataflow the paper discusses (§4.3).

On a CUDA tensor :func:`matmul` launches the hand-written Hopper kernel in
``csrc/matmul.cu`` (it replaces the Pallas kernels
``repro/kernels/matmul.py::_os_kernel`` and ``::_acc_kernel``) or raises;
on a CPU tensor it runs the plain version ``ref.matmul``. There is no other
route and no fallback. The kernel takes ragged M, K and N and strided
operands, so nothing is padded or copied.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

DATAFLOWS = ("output_stationary", "weight_stationary", "input_stationary")
# the kernel's output tile (csrc/matmul.cu BM = BN) and its grid limit
TILE = 64
MAX_N = 65535 * TILE

# kernel launches per dataflow: plain integers, raised by one exactly where
# the kernel is launched, so a run can show that its GEMMs went through it
LAUNCHES = {df: 0 for df in DATAFLOWS}

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_void_p])


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib():
    from repro_torch.kernels import _build
    fn = _build.load("matmul").repro_matmul
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def check_operands(name, x, w):
    """Two 2-D operands with matching inner dimension, on one device; the
    reference asserts ``K == K2`` with the two shapes as its message."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name} wants x (M, K) and w (K, N); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.shape[1] != w.shape[0]:
        raise AssertionError((tuple(x.shape), tuple(w.shape)))
    if x.device != w.device:
        raise ValueError(f"{name}: x and w must share a device")


def launch_geometry(x, w):
    """(M, K, N) and the element strides the kernels read x and w with."""
    M, K = x.shape
    N = w.shape[1]
    if N > MAX_N:
        raise ValueError(f"the GEMM kernels take N <= {MAX_N}, got {N}")
    return (M, K, N, x.stride(0), x.stride(1), w.stride(0), w.stride(1))


def matmul(x, w, *, block_m: int = 128, block_n: int = 128,
           block_k: int = 128, dataflow: str = "output_stationary"):
    """x: (M, K) @ w: (K, N) -> (M, N) in x's dtype, fp32 accumulation.

    x and w are float32, or both bfloat16 on the card. ``dataflow`` picks
    which operand a block keeps resident across its sweep. The block sizes
    are the reference's: on the card the kernel's tile is 64 x 64 x 16, and
    a weight-stationary block sweeps ceil(block_m / 64) M-tiles under one
    staged weight tile (input-stationary: ceil(block_n / 64) N-tiles under
    one staged input tile); ``block_k`` is accepted for parity."""
    check_operands("matmul", x, w)
    if dataflow not in DATAFLOWS:
        raise ValueError(f"unknown dataflow {dataflow!r}")
    if min(block_m, block_n, block_k) < 1:
        raise ValueError(f"block sizes must be >= 1, got "
                         f"{(block_m, block_n, block_k)}")
    if not x.is_cuda:
        return ref.matmul(x, w)
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"matmul kernel takes float32 or bfloat16 x and w of "
                        f"one dtype, got {x.dtype} and {w.dtype}")
    geometry = launch_geometry(x, w)
    M, _, N = geometry[:3]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    acc = out
    if dataflow != "output_stationary" and x.dtype != torch.float32:
        acc = torch.empty((M, N), dtype=torch.float32, device=x.device)
    group = -(-(block_m if dataflow == "weight_stationary" else block_n)
              // TILE)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib()(x.data_ptr(), w.data_ptr(), acc.data_ptr(),
                     out.data_ptr(), *geometry,
                     int(x.dtype == torch.bfloat16),
                     DATAFLOWS.index(dataflow), group, stream)
    if err:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {err}")
    LAUNCHES[dataflow] += 1
    return out
