"""The linear recurrences of the recurrent families: the RWKV6 wkv scan
(rwkv6's time mix) and the mamba selective scan (hymba's SSM branch), in
fp32.

On a CUDA tensor :func:`wkv6` and :func:`selective_scan` launch the
hand-written Hopper kernels in ``csrc/linear_scan.cu``
(``repro_wkv6_f32``, ``repro_selective_scan_f32``; they replace the Pallas
kernels ``repro/kernels/linear_scan.py::_wkv6_kernel`` and
``::_sscan_kernel``) or raise; on a CPU tensor they run the plain versions
``ref.wkv6`` and ``ref.selective_scan``. There is no other route and no
fallback. :func:`scan_plan` chooses each launch's block shape, its split
over value columns (K5) or channels (K6) and its staging depth; no plan
changes a bit of the result.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import SMEM_MAX, SMS

# the widest state each kernel takes (rwkv6's head_dim is 64, hymba's
# ssm_state 16)
WKV_MAX_N = 64
SSCAN_MAX_N = 32
MAX_BATCH = 65535

# csrc/linear_scan.cu's constants: K5's row groups and ring stages, K6's
# steps reduced together, its largest block, and the shared memory below
# which K6's staging depth is kept (so several blocks share an SM)
WKV_GROUPS, WKV_RING = 8, 2
SS_U, SS_MAX_THREADS = 16, 256
SSCAN_STAGE_BYTES = 48 * 1024

# kernel launches per kernel: plain integers, raised by one exactly where
# the kernel is launched, so a run can show that its recurrences went
# through it
LAUNCHES = {"wkv6": 0, "selective_scan": 0}

_ARGTYPES = {
    "wkv6": ("repro_wkv6_f32",
             [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]),
    "selective_scan": ("repro_selective_scan_f32",
                       [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p]),
}


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib(kernel: str):
    from repro_torch.kernels import _build
    symbol, argtypes = _ARGTYPES[kernel]
    fn = getattr(_build.load("linear_scan"), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _wkv_nmax(N: int) -> int:
    return 16 if N <= 16 else 32 if N <= 32 else 64


def _wkv_smem(nmax: int, cols: int, steps: int) -> int:
    """Bytes of K5's shared memory: the ring of staged steps (r, k, w of
    ``nmax`` rows, v of ``cols`` columns) and the row groups' partial
    outputs, double-buffered."""
    return 4 * (WKV_RING * steps * (3 * nmax + cols)
                + 2 * steps * WKV_GROUPS * cols)


def _sscan_smem(G: int, cols: int, steps: int) -> int:
    """Bytes of K6's shared memory: two passes of dt and x of ``cols``
    channels and b and c of ``G`` lanes (rows of the steps rounded up to
    SS_U, plus 4), and the outputs."""
    rounded = _cdiv(steps, SS_U) * SS_U
    return 4 * (2 * (rounded + 4) * (2 * cols + 2 * G) + rounded * cols)


@dataclass(frozen=True)
class ScanPlan:
    """How a scan kernel runs one call: ``cols`` value columns (K5) or
    channels (K6) per block, ``thread_cols`` of K5's columns per thread
    (1 or 2; 1 for K6), ``steps`` staged per pass (per stage of a two-stage
    cp.async ring; K6 at T = 1 stages nothing), ``vec`` K5's 16-byte
    copies; ``blocks`` in the grid, ``threads`` per block and ``smem``
    bytes of shared memory per block."""
    kernel: str
    cols: int
    thread_cols: int
    steps: int
    vec: bool
    blocks: int
    threads: int
    smem: int

    def c_args(self) -> tuple:
        if self.kernel == "wkv6":
            return (self.cols, self.thread_cols, self.steps, int(self.vec))
        return (self.cols, self.steps)


def _plan(kernel: str, B: int, T: int, W: int, N: int, cols: int,
          steps: int, vec: bool = False, thread_cols: int = 1) -> ScanPlan:
    """The plan with these choices, checked as ``csrc/linear_scan.cu``
    checks it: ``W`` is K5's H or K6's D."""
    if cols < 1 or cols & (cols - 1) or thread_cols < 1:
        raise ValueError(f"scan_plan: {kernel} takes a power of two of "
                         f"columns per block, got cols={cols}")
    if kernel == "wkv6":
        nmax = _wkv_nmax(N)
        threads = WKV_GROUPS * cols // thread_cols
        blocks = B * W * (nmax // cols)
        ok = (cols <= nmax and thread_cols in (1, 2) and threads >= 32
              and (N % 4 == 0 or not vec))
        smem = _wkv_smem(nmax, cols, steps)
    else:
        G = _pow2_at_least(N)
        threads, blocks = cols * G, B * _cdiv(W, cols)
        ok = 32 <= threads <= SS_MAX_THREADS and thread_cols == 1 and not vec
        smem = 0 if T == 1 else _sscan_smem(G, cols, steps)
    if not (ok and steps >= 1 and smem <= SMEM_MAX):
        raise ValueError(f"scan_plan: {kernel} cannot run cols={cols}, "
                         f"thread_cols={thread_cols}, steps={steps}, "
                         f"vec={vec} at {(B, T, W, N)}")
    return ScanPlan(kernel, cols, thread_cols, steps, vec, blocks, threads,
                    smem)


def scan_plan(kernel: str, B: int, T: int, W: int, N: int, *, chunk: int,
              ptrs: tuple = ()) -> ScanPlan:
    """The plan for ``kernel`` ('wkv6': W = H heads of N; 'selective_scan':
    W = D channels, state N) over B rows of T steps; ``ptrs`` are K5's r,
    k, v, w data pointers.

    K5: 2 value columns a thread where that still gives every SM
    sub-partition a warp, else 1; then the widest column block (at most the
    padded N, at least a warp) that still gives SMS blocks, so a B=1 chunk
    of 64 heads splits each head 4 ways and a tick of 8 slots not at all;
    ``chunk`` steps a ring stage (at most T), fewer where two blocks would
    not share an SM; 16-byte copies where N is a multiple of 4 and every
    pointer 16-byte aligned.
    K6: the most channels a block (at most 256 threads) that still give
    SMS blocks, else the fewest; ``chunk`` steps a pass (at most T), cut by
    SS_U while the staging passes SSCAN_STAGE_BYTES. Raises ``ValueError``
    for what the kernels cannot take."""
    maxn = {"wkv6": WKV_MAX_N, "selective_scan": SSCAN_MAX_N}.get(kernel)
    if maxn is None:
        raise ValueError(f"scan_plan: unknown kernel {kernel!r}")
    if not (1 <= B <= MAX_BATCH and T >= 1 and W >= 1 and 1 <= N <= maxn
            and chunk >= 1):
        raise ValueError(f"scan_plan: {kernel} takes 1 <= B <= {MAX_BATCH}, "
                         f"T >= 1, H or D >= 1, 1 <= N <= {maxn} and chunk "
                         f">= 1; got {(B, T, W, N)}, chunk={chunk}")
    steps = min(chunk, T)
    if kernel == "wkv6":
        nmax = _wkv_nmax(N)
        # two columns a thread where that still gives every SM
        # sub-partition a warp
        tc = 2 if B * W * WKV_GROUPS * nmax // 2 >= 4 * 32 * SMS else 1
        cols = nmax
        while (WKV_GROUPS * cols // 2 // tc >= 32
               and B * W * (nmax // cols) < SMS):
            cols //= 2
        while steps > 1 and 2 * _wkv_smem(nmax, cols, steps) > SMEM_MAX:
            steps -= 1
        vec = N % 4 == 0 and all(p % 16 == 0 for p in ptrs)
        return _plan(kernel, B, T, W, N, cols, steps, vec, tc)
    G = _pow2_at_least(N)
    widths = [c for c in (1 << i for i in range(9))
              if 32 <= c * G <= SS_MAX_THREADS]
    filling = [c for c in widths if B * _cdiv(W, c) >= SMS]
    cols = max(filling) if filling else min(widths)
    if T == 1:
        steps = 1
    while steps > SS_U and _sscan_smem(G, cols, steps) > SSCAN_STAGE_BYTES:
        steps -= SS_U
    return _plan(kernel, B, T, W, N, cols, steps)


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


def run_plan(plan: ScanPlan, args):
    """Launch ``plan.kernel`` on ``args`` (r, k, v, w, u, s0 or x, dt, b,
    c, a, h0: checked card tensors) and count the launch; returns (y, final
    state)."""
    first = args[0]
    if plan.kernel == "wkv6":
        B, T, H, N = first.shape
        y = torch.empty((B, T, H, N), dtype=torch.float32,
                        device=first.device)
        state = torch.empty((B, H, N, N), dtype=torch.float32,
                            device=first.device)
    else:
        B, T, D = first.shape
        N = args[2].shape[-1]
        y = torch.empty((B, T, D), dtype=torch.float32, device=first.device)
        state = torch.empty((B, D, N), dtype=torch.float32,
                            device=first.device)
    stream = torch.cuda.current_stream(first.device).cuda_stream
    with torch.cuda.device(first.device):
        err = _lib(plan.kernel)(*(t.data_ptr() for t in (*args, y, state)),
                                B, T, first.shape[2], N, *plan.c_args(),
                                stream)
    if err:
        raise RuntimeError(f"{plan.kernel} kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[plan.kernel] += 1
    return y, state


def wkv6(r, k, v, w, u, s0, *, chunk: int = 32):
    """r, k, v, w: (B, T, H, N); u: (H, N); s0: (B, H, N, N) -> (y (B, T,
    H, N), sT (B, H, N, N)), fp32. The kernel takes any B (up to 65535), T
    >= 1, H and N <= 64; ``chunk`` sets how many steps a stage of its ring
    holds (``scan_plan``), not the result."""
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
    plan = scan_plan("wkv6", B, T, H, N, chunk=int(chunk),
                     ptrs=tuple(t.data_ptr() for t in (r, k, v, w)))
    return run_plan(plan, (r, k, v, w, u, s0))


def selective_scan(x, dt, b, c, a, h0, *, chunk: int = 64):
    """x, dt: (B, T, D); b, c: (B, T, N); a: (D, N); h0: (B, D, N) -> (y
    (B, T, D), hT (B, D, N)), fp32. The kernel takes any B (up to 65535),
    T >= 1, D and N <= 32; ``chunk`` sets how many steps it stages at a
    time (``scan_plan``), not the result."""
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
    plan = scan_plan("selective_scan", B, T, D, N, chunk=int(chunk))
    return run_plan(plan, (x, dt, b, c, a, h0))
