"""The systolic tiled GEMM: out = x @ w with fp32 accumulation, in the
output-, weight- or input-stationary dataflow the paper discusses (§4.3).

On a CUDA tensor :func:`matmul` launches the hand-written Hopper kernel in
``csrc/matmul.cu`` (it replaces the Pallas kernels
``repro/kernels/matmul.py::_os_kernel`` and ``::_acc_kernel``) or raises;
on a CPU tensor it runs the plain version ``ref.matmul``. There is no other
route and no fallback. The kernel takes ragged M, K and N and strided
operands, so nothing is padded or copied. :func:`tile_plan` chooses its
schedule, tiles, K-chunks, split and grid from the shape, in Python, so
that the CPU tests can check the choice; the kernel checks the plan it is
given. A long reduction under a small output (the backward's dW = X^T g)
is split over blocks into contiguous ranges fixed by the shape, and the
partial sums are added in a fixed order by a second launch, so the bits
do not depend on scheduling.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import SMEM_MAX, SMS

DATAFLOWS = ("output_stationary", "weight_stationary", "input_stationary")

# a grid of FILL blocks or more fills the card (ResNet20's N = 64 GEMMs at
# batch 256 are 128 tiles of 8 x 4 micro-tiles: one wave on 128 of the 132
# SMs)
FILL = 120
# csrc/matmul.cu's tiled kernel: 256 threads, BK-deep ring stages of x
# (row pitch LDX floats), an N-tile per BN in TILE_N, TM rows of 4 columns
# per thread for TM in MICRO_M
THREADS, BK, STAGES, LDX = 256, 16, 3, 20
TILE_N = (16, 32, 64)
MICRO_M = (8, 4, 1)
# its skinny kernel (M <= SKINNY_M): SK_COLS columns per block, raw w
# through SK_STAGES ring stages of SK_STAGE_BYTES
SKINNY_M, SK_COLS, SK_STAGES, SK_STAGE_BYTES = 16, 32, 4, 8192
# its split schedule (a long reduction under an output of too few tiles to
# fill the card): the reduction cut into contiguous ranges, at least
# SPLIT_MIN rows each (but the last), one block per (tile, range), x and w
# streamed through SPLIT_STAGES ring stages of SPLIT_BK[tm] rows (a range
# is a multiple of them); fewer than MIN_SPLITS ranges do not pay for the
# second launch, and its partials of 32 elements fit 48 KB (MAX_SPLITS)
SPLIT_MIN, MIN_SPLITS, MAX_SPLITS, SPLIT_STAGES = 256, 4, 384, 4
SPLIT_BK = {1: 64, 4: BK, 8: BK}
# its wide schedule (a reduction of K <= WIDE_K under an output wider than
# one N-tile, the backward's dX = g W^T): all of w resident in N-panels of
# row pitch BN + 4, x's M-tiles double-buffered
WIDE_K = 64
SCHEDULES = ("tiled", "skinny", "split", "wide")
# the grid's y dimension holds N-tiles
MAX_N = 65535 * TILE_N[-1]

# kernel launches per dataflow: plain integers, raised by one exactly where
# the kernel is launched, so a run can show that its GEMMs went through it
LAUNCHES = {df: 0 for df in DATAFLOWS}

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_void_p])


@dataclass(frozen=True)
class TilePlan:
    """How the kernel runs one GEMM. ``schedule``:

    - ``skinny`` (M <= 16): ``bn`` columns per block, x resident;
    - ``tiled``: a block of 256 threads owns a ``bm`` x ``bn`` output tile,
      ``tm`` rows of 4 columns per thread, and sweeps ``group`` tiles
      (weight-stationary: M-tiles under its resident w; input-stationary:
      N-tiles under its resident x); ``kc`` is the K-chunk the resident
      operand holds (``chunks`` of them cover K);
    - ``split``: the same tiles, one block per (tile, range of ``kc``
      reduction rows), ``splits`` ranges; grid (tiles, splits); each block
      writes its partial tile to an f32 (splits, M, N) scratch, and a second
      launch sums the ranges in order;
    - ``wide``: all of w (``kc`` >= K rows) resident, each block sweeps
      ``group`` M-tiles of ``bm`` rows through every N-tile.

    ``vec_x``: x staged by 16-byte copies (along k; ``split``: along m,
    into a k-major tile); ``vec_w``: w by vector loads (four consecutive n;
    skinny: 16 bytes). ``smem``: dynamic shared memory per block in
    bytes."""
    schedule: str
    bn: int
    tm: int
    bm: int
    kc: int
    chunks: int
    group: int
    vec_x: bool
    vec_w: bool
    smem: int
    grid: tuple
    splits: int = 1

    @property
    def skinny(self) -> bool:
        return self.schedule == "skinny"

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    def c_args(self) -> tuple:
        return (SCHEDULES.index(self.schedule), self.bn, self.tm, self.kc,
                self.group, int(self.vec_x), int(self.vec_w))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _cost(M, bm, tm, blocks) -> float:
    """A split or wide plan's shared-memory bytes per SM, relative: the
    padded rows times what a thread reads per FMA (TM x values and four w
    values every k for 4 TM FMAs), over the SMs its blocks occupy."""
    return _cdiv(M, bm) * bm * (tm + 4) / tm / min(blocks, SMS)


def _wide_plan(M, K, N, x_bytes, vec_x, vec_w):
    """The wide schedule, where the reduction is short (K <= WIDE_K) and
    the output wider than one N-tile, so that the tiled schedule would read
    x's rows once per N-tile: BN leaves the fewest padded columns (the
    wider on a tie), TM the least ``_cost``, the larger on a tie; each
    block sweeps enough M-tiles that the grid is about as many blocks as
    fit on the card at once. None where the shape is not such or w does
    not fit."""
    if K > WIDE_K or N <= TILE_N[-1]:
        return None
    kc = _cdiv(max(K, 1), BK) * BK
    bn = min(TILE_N, key=lambda t: (_cdiv(N, t) * t, -t))
    panels = 4 * kc * _cdiv(N, bn) * (bn + 4)
    best = None
    for tm in MICRO_M if x_bytes == 4 else (1,):
        bm = tm * THREADS // (bn // 4)
        smem = panels + 4 * 2 * bm * (kc + 4)
        if smem > SMEM_MAX:
            continue
        mt = _cdiv(M, bm)
        group = _cdiv(mt, SMS * min(2, SMEM_MAX // smem))
        plan = TilePlan("wide", bn, tm, bm, kc, 1, group, vec_x, vec_w, smem,
                        (_cdiv(mt, group), 1))
        key = (_cost(M, bm, tm, mt), -tm)
        if best is None or key < best[0]:
            best = (key, plan)
    return best and best[1]


def _split_plan(M, K, N, sxm, sxk, x_bytes, x_ptr, vec_w):
    """The split schedule, where the output has too few tiles to fill the
    card and the reduction is long: S ranges of ``kc`` rows (a multiple of
    the stage's SPLIT_BK[tm], at least SPLIT_MIN but the last), as many as
    keep tiles x S within one wave of two blocks per SM (one where two do
    not fit in shared memory, or where the reduction's length leaves the
    second wave thin); the ranges depend on (M, K, N) and the tile alone.
    TM takes the least ``_cost``, then the fewer padded rows, then the
    larger TM. None where no split of MIN_SPLITS ranges or more gives more
    blocks than the tiled schedule's smallest tiles."""
    bn = next((t for t in TILE_N if N <= t), TILE_N[-1])
    nt = _cdiv(N, bn)
    tiled = _cdiv(M, THREADS // (bn // 4)) * nt   # the tiled plan's most
    if tiled >= FILL:
        return None
    vec_x = (x_bytes == 4 and sxm == 1 and sxk % 4 == 0 and M % 4 == 0
             and x_ptr % 16 == 0)
    best = None
    for tm in MICRO_M if x_bytes == 4 else (1,):
        bm = tm * THREADS // (bn // 4)
        tiles = _cdiv(M, bm) * nt
        smem = 4 * SPLIT_STAGES * SPLIT_BK[tm] * (bm + 4 + bn)
        per_sm = 2 if 2 * smem <= SMEM_MAX - 2048 else 1
        splits = min(per_sm * SMS // tiles, K // SPLIT_MIN, MAX_SPLITS)
        if SMS < tiles * splits < 2 * FILL:
            # a thin second wave: the SMs that hold two blocks set the pace
            splits = SMS // tiles
        if splits < MIN_SPLITS or tiles * splits <= tiled:
            continue
        kc = _cdiv(_cdiv(K, splits), SPLIT_BK[tm]) * SPLIT_BK[tm]
        splits = _cdiv(K, kc)
        plan = TilePlan("split", bn, tm, bm, kc, splits, 1, vec_x, vec_w,
                        smem, (tiles, splits), splits)
        key = (_cost(M, bm, tm, tiles * splits), _cdiv(M, bm) * bm, -tm)
        if best is None or key < best[0]:
            best = (key, plan)
    return best and best[1]


def tile_plan(M, K, N, sxm, sxk, swk, swn, *,
              dataflow: str = "output_stationary", x_bytes: int = 4,
              w_bytes: int = 4, x_ptr: int = 0, w_ptr: int = 0,
              block_m: int = 128, block_n: int = 128) -> TilePlan:
    """The plan for x (M, K) @ w (K, N) with element strides (sxm, sxk),
    (swk, swn), element sizes ``x_bytes`` / ``w_bytes`` (w int8: K8) and
    base addresses ``x_ptr`` / ``w_ptr``.

    A short reduction under a wide output takes the wide schedule
    (``_wide_plan``; not at M <= 16), a long reduction under a small output
    the split one (``_split_plan``), and else M <= 16 the skinny one; these
    three are the same for every dataflow. Otherwise BN is the smallest
    tile of ``TILE_N`` that covers N (64 beyond), and of the ``MICRO_M``
    choices the plan prefers, in order: a grid that fills the card (at
    least ``FILL`` blocks), one K-chunk (the resident operand covers K),
    then the larger TM where the card is filled (a larger micro-tile reads
    shared memory less per FMA) and the more blocks where it is not (bf16
    x, off the timed paths, takes TM = 1 only, which keeps the build
    short). ``block_m`` / ``block_n`` (the reference's block sizes) set the
    weight- / input-stationary sweep, capped so the grid still fills the
    card."""
    if dataflow not in DATAFLOWS:
        raise ValueError(f"unknown dataflow {dataflow!r}")
    vec_x = (x_bytes == 4 and sxk == 1 and K % 4 == 0 and sxm % 4 == 0
             and x_ptr % 16 == 0)
    vec_w = (swn == 1 and N % 4 == 0 and swk % 4 == 0
             and w_ptr % (4 * w_bytes) == 0)
    plan = ((M > SKINNY_M and _wide_plan(M, K, N, x_bytes, vec_x, vec_w))
            or _split_plan(M, K, N, sxm, sxk, x_bytes, x_ptr, vec_w))
    if plan:
        return plan
    if M <= SKINNY_M:
        kt = SK_STAGE_BYTES // (SK_COLS * w_bytes)
        ring = SK_STAGES * SK_STAGE_BYTES
        kc = min(_cdiv(max(K, 1), kt) * kt,
                 (SMEM_MAX - ring) // (4 * M) // kt * kt)
        vec_w = (swn == 1 and N % (16 // w_bytes) == 0
                 and (swk * w_bytes) % 16 == 0 and w_ptr % 16 == 0)
        return TilePlan("skinny", SK_COLS, 0, M, kc, _cdiv(K, kc), 1, vec_x,
                        vec_w, ring + 4 * M * kc, (_cdiv(N, SK_COLS), 1))
    bn = next((t for t in TILE_N if N <= t), TILE_N[-1])
    xres = dataflow == "input_stationary"
    k_all = _cdiv(max(K, 1), BK) * BK
    best = None
    for tm in MICRO_M if x_bytes == 4 else (1,):
        bm = tm * THREADS // (bn // 4)
        # resident x chunk (bm x (kc + 4)) and a ring of w tiles, or a ring
        # of x tiles and a resident w chunk (kc x bn); a chunk of fewer
        # tiles than STAGES takes as many ring slots as it has tiles
        slot = 4 * (BK * bn if xres else bm * LDX)
        per_k = 4 * bm if xres else 4 * bn
        fit = (SMEM_MAX - STAGES * slot - (4 * 4 * bm if xres else 0)) \
            // per_k // BK * BK
        if fit < BK:
            continue
        kc = min(k_all, fit)
        smem = (min(STAGES, kc // BK) * slot + per_k * kc
                + (4 * 4 * bm if xres else 0))
        mt, nt = _cdiv(M, bm), _cdiv(N, bn)
        group = 1
        if dataflow != "output_stationary":
            want, swept = ((_cdiv(block_n, bn), nt) if xres
                           else (_cdiv(block_m, bm), mt))
            group = max(1, min(want, swept, mt * nt // SMS))
        grid = ((mt, _cdiv(nt, group)) if xres
                else (_cdiv(mt, group), nt))
        plan = TilePlan("tiled", bn, tm, bm, kc, _cdiv(K, kc), group, vec_x,
                        vec_w, smem, grid)
        fills = min(plan.blocks, SMS) >= FILL
        key = (fills, kc >= k_all, tm if fills else plan.blocks, tm)
        if best is None or key > best[0]:
            best = (key, plan)
    return best[1]


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


def plan_for(x, w, geometry, dataflow="output_stationary", block_m=128,
             block_n=128) -> TilePlan:
    """:func:`tile_plan` for these tensors."""
    return tile_plan(*geometry, dataflow=dataflow,
                     x_bytes=x.element_size(), w_bytes=w.element_size(),
                     x_ptr=x.data_ptr(), w_ptr=w.data_ptr(),
                     block_m=block_m, block_n=block_n)


def scratch(plan, M, N, dataflow, dtype, device):
    """The f32 scratch the kernel takes beside ``out`` (from the caching
    allocator; every element it reads it has written first): the split
    schedule's (splits, M, N) partial sums, or the (M, N) running sum that
    a weight- or input-stationary tiled plan re-streams between K-chunks
    when ``out`` is not f32; None where the kernel needs none."""
    if plan.splits > 1:
        return torch.empty((plan.splits, M, N), dtype=torch.float32,
                           device=device)
    if (plan.schedule == "tiled" and dataflow != "output_stationary"
            and dtype != torch.float32 and plan.chunks > 1):
        return torch.empty((M, N), dtype=torch.float32, device=device)
    return None


def matmul(x, w, *, block_m: int = 128, block_n: int = 128,
           block_k: int = 128, dataflow: str = "output_stationary"):
    """x: (M, K) @ w: (K, N) -> (M, N) in x's dtype, fp32 accumulation.

    x and w are float32, or both bfloat16 on the card. ``dataflow`` picks
    which operand a block keeps resident across its sweep. The block sizes
    are the reference's: on the card :func:`tile_plan` sizes the tile to
    the shape, and ``block_m`` / ``block_n`` set how many M-tiles a
    weight-stationary block (N-tiles an input-stationary block) sweeps
    under its resident operand; ``block_k`` is accepted for parity. The
    skinny (M <= 16), split and wide schedules are the same in every
    dataflow. A split GEMM is two launches (the partial sums, then their
    sum in order), counted once."""
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
    plan = plan_for(x, w, geometry, dataflow, block_m, block_n)
    acc = scratch(plan, M, N, dataflow, x.dtype, x.device)
    if acc is None:
        acc = out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib()(x.data_ptr(), w.data_ptr(), acc.data_ptr(),
                     out.data_ptr(), *geometry,
                     int(x.dtype == torch.bfloat16),
                     DATAFLOWS.index(dataflow), *plan.c_args(), stream)
    if err:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {err}")
    LAUNCHES[dataflow] += 1
    return out
