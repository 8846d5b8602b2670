"""The linear recurrences of the recurrent families: the RWKV6 wkv scan
(rwkv6's time mix) and the mamba selective scan (hymba's SSM branch), in
fp32.

On a CUDA tensor :func:`wkv6` and :func:`selective_scan` launch the
hand-written Hopper kernels in ``csrc/linear_scan.cu``
(``repro_wkv6_f32``, ``repro_selective_scan_f32``; they replace the Pallas
kernels ``repro/kernels/linear_scan.py::_wkv6_kernel`` and
``::_sscan_kernel``) or raise; on a CPU tensor they run the plain versions
``ref.wkv6`` and ``ref.selective_scan``. There is no other route and no
fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

# the widest state each kernel takes (rwkv6's head_dim is 64, hymba's
# ssm_state 16)
WKV_MAX_N = 64
SSCAN_MAX_N = 32
MAX_BATCH = 65535

# kernel launches per kernel: plain integers, raised by one exactly where
# the kernel is launched, so a run can show that its recurrences went
# through it
LAUNCHES = {"wkv6": 0, "selective_scan": 0}

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib(symbol: str):
    from repro_torch.kernels import _build
    fn = getattr(_build.load("linear_scan"), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_shapes(name, named, want):
    for arg, t in named.items():
        if tuple(t.shape) != want[arg]:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"want {want[arg]}")


def _check_card(name, first, named):
    """Everything on ``first``'s device, float32 and contiguous."""
    for arg, t in named.items():
        if t.device != first.device:
            raise ValueError(f"{name}: all tensors must share one device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32 tensors, got "
                            f"{arg} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _on_cpu(name, first, named) -> bool:
    if first.is_cuda:
        return False
    if any(t.is_cuda for t in named.values()):
        raise ValueError(f"{name}: all tensors must share one device")
    return True


def _launch(symbol, first, args, outs, dims, chunk):
    stream = torch.cuda.current_stream(first.device).cuda_stream
    with torch.cuda.device(first.device):
        err = _lib(symbol)(*(t.data_ptr() for t in args + outs), *dims,
                           chunk, stream)
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error "
                           f"{err}")


def wkv6(r, k, v, w, u, s0, *, chunk: int = 32):
    """r, k, v, w: (B, T, H, N); u: (H, N); s0: (B, H, N, N) -> (y (B, T,
    H, N), sT (B, H, N, N)), fp32. The kernel takes any B (up to 65535), T
    >= 1, H and N <= 64; ``chunk`` sets how many steps it stages at a time
    (at most 16), not the result."""
    if r.dim() != 4:
        raise ValueError(f"wkv6 wants r (B, T, H, N), got {tuple(r.shape)}")
    B, T, H, N = r.shape
    named = dict(r=r, k=k, v=v, w=w, u=u, s0=s0)
    _check_shapes("wkv6", named, dict(r=(B, T, H, N), k=(B, T, H, N),
                                      v=(B, T, H, N), w=(B, T, H, N),
                                      u=(H, N), s0=(B, H, N, N)))
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if _on_cpu("wkv6", r, named):
        return ref.wkv6(r, k, v, w, u, s0)
    _check_card("wkv6", r, named)
    if not (1 <= B <= MAX_BATCH and T >= 1 and H >= 1
            and 1 <= N <= WKV_MAX_N):
        raise ValueError(f"wkv6 kernel takes 1 <= B <= {MAX_BATCH}, T >= 1, "
                         f"H >= 1 and 1 <= N <= {WKV_MAX_N}; got "
                         f"{(B, T, H, N)}")
    y = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    sT = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    _launch("repro_wkv6_f32", r, [r, k, v, w, u, s0], [y, sT],
            (B, T, H, N), int(chunk))
    LAUNCHES["wkv6"] += 1
    return y, sT


def selective_scan(x, dt, b, c, a, h0, *, chunk: int = 64):
    """x, dt: (B, T, D); b, c: (B, T, N); a: (D, N); h0: (B, D, N) -> (y
    (B, T, D), hT (B, D, N)), fp32. The kernel takes any B (up to 65535),
    T >= 1, D and N <= 32; ``chunk`` sets how many steps it stages at a
    time, not the result."""
    if x.dim() != 3 or b.dim() != 3:
        raise ValueError(f"selective_scan wants x (B, T, D) and b (B, T, N); "
                         f"got {tuple(x.shape)}, {tuple(b.shape)}")
    B, T, D = x.shape
    N = b.shape[-1]
    named = dict(x=x, dt=dt, b=b, c=c, a=a, h0=h0)
    _check_shapes("selective_scan", named, dict(
        x=(B, T, D), dt=(B, T, D), b=(B, T, N), c=(B, T, N), a=(D, N),
        h0=(B, D, N)))
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if _on_cpu("selective_scan", x, named):
        return ref.selective_scan(x, dt, b, c, a, h0)
    _check_card("selective_scan", x, named)
    if not (1 <= B <= MAX_BATCH and T >= 1 and D >= 1
            and 1 <= N <= SSCAN_MAX_N):
        raise ValueError(f"selective_scan kernel takes 1 <= B <= "
                         f"{MAX_BATCH}, T >= 1, D >= 1 and 1 <= N <= "
                         f"{SSCAN_MAX_N}; got {(B, T, D, N)}")
    y = torch.empty((B, T, D), dtype=torch.float32, device=x.device)
    hT = torch.empty((B, D, N), dtype=torch.float32, device=x.device)
    _launch("repro_selective_scan_f32", x, [x, dt, b, c, a, h0], [y, hT],
            (B, T, D, N), int(chunk))
    LAUNCHES["selective_scan"] += 1
    return y, hT
