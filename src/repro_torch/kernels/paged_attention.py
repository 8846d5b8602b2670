"""Paged attention: block-table-indirect attention over a shared KV page
pool, for both serving shapes (decode Sq = 1, prefill chunk Sq = C), in
three representations: fp32 or bf16 GQA pools, int8 GQA pools with
per-page f32 scales, and MLA latent pools (one row per token shared by
every head, fp32 or bf16). q is fp32 or bf16 over any of them, as the
Pallas kernels take any float type: every operand is upcast to fp32 inside
the kernel and the output comes back in q's dtype.

On a CUDA tensor :func:`paged_attention` launches the hand-written Hopper
kernel in ``csrc/paged_attention.cu`` (it replaces the Pallas kernels
``repro/kernels/paged_attention.py::_kernel`` and, given scales,
``::_kernel_q8``) and :func:`paged_attention_latent` the one in
``csrc/paged_attention_latent.cu`` (replacing ``::_kernel_latent``), or
they raise; on a CPU tensor each runs its plain version in
``kernels.ref``. There is no other route and no fallback.
:func:`paged_plan` and :func:`latent_plan` choose each kernel's tiles, ring
depth, staging width and split over keys from the shapes, in Python, so
that the CPU tests can check the choice; the kernel checks the plan it is
given. A call that does not fill the card (a decode tick) divides each
slot's keys among several blocks, which leave partial results in scratch
this module allocates, and a second launch (``csrc/split_merge.cuh``,
shared by both kernels) merges them; the pair counts as one launch.
Under tensor parallelism :func:`paged_attention_head_sharded` and
:func:`paged_attention_latent_head_sharded` launch the same kernels on a
rank's head slab with the plan of the whole-head call.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import SMEM_MAX, SMS

_DT = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the (q, pool) dtype pairs of each kernel's C entries
POOL_DTYPES = {"paged": (torch.float32, torch.bfloat16),
               "q8": (torch.int8,),
               "latent": (torch.float32, torch.bfloat16)}


def launch_suffix(q_dtype, pool_dtype) -> str:
    """The dtype part of a launch count's key: none for fp32 q over fp32
    (or int8) pools, "_bf16" for bf16 q over bf16 (or int8) pools, else
    "_<q>_<pool>" ("_bf16_f32": bf16 q over fp32 pools)."""
    qn = _DT[q_dtype]
    pn = qn if pool_dtype == torch.int8 else _DT[pool_dtype]
    if qn == pn:
        return "" if qn == "f32" else "_bf16"
    return f"_{qn}_{pn}"


# kernel launches per caller and dtypes: plain integers, raised by one
# exactly where a kernel is launched, so a run can show that its attention
# went through the kernel. fp32 / bf16 pools count under "decode" /
# "prefill", int8 pools under "*_q8", latent pools under "*_latent", each
# with the suffix of :func:`launch_suffix` ("decode_bf16", "decode_q8_bf16",
# "prefill_latent_bf16_f32", ...).
LAUNCHES = {f"{kind}{tag}{launch_suffix(q, p)}": 0
            for kind in ("decode", "prefill")
            for tag, pools in (("", POOL_DTYPES["paged"]),
                               ("_q8", POOL_DTYPES["q8"]),
                               ("_latent", POOL_DTYPES["latent"]))
            for q in _DT for p in pools}

MAX_HEAD_DIM = 256
MAX_LATENT_WIDTH = 1024

# csrc/paged_attention_latent.cu: 512 threads, key tiles of 16 rows, row
# tiles of 32 or 16 query rows, a ring of 2 or 3 key tiles
LATENT_THREADS, LATENT_KEY_TILE = 512, 16
LATENT_ROWS = (32, 16)

# csrc/paged_attention.cu: 8 warps; row tiles of 64 or 16 flattened query
# rows (8 or 2 a warp), key tiles of 64 keys (with 64-row tiles only) or
# 32, a ring of 2 or 3 key tiles; P staged 32 keys at a time
PAGED_PC = 32
PAGED_ROWS = (64, 16)
PAGED_KEY_TILES = (64, 32)
MAX_SPLITS = 1024    # csrc/split_merge.cuh, for K1 / K3 and K4

# the argument types of the C entries repro_paged_attention_<q>_<pool>
# (paged_attention.cu) and repro_paged_attention_latent_<q>_<pool>
# (paged_attention_latent.cu)
_ARGTYPES = {"paged": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 14
             + [ctypes.c_float, ctypes.c_void_p],
             "q8": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 14
             + [ctypes.c_float, ctypes.c_void_p],
             "latent": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
             + [ctypes.c_float, ctypes.c_void_p]}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _head_pad(hd: int) -> int:
    """head_dim padded to the paged kernel's 64, 128 or 256."""
    return 64 if hd <= 64 else 128 if hd <= 128 else 256


def _paged_smem(rows: int, kt: int, hdp: int, stages: int,
                elem: int) -> int:
    """Bytes of the paged kernel's shared memory (its ``layout``) over
    pools of ``elem``-byte elements (4 fp32, 2 bf16, 1 int8): Q (``rows``
    of hdp + 4 floats), P, a read flag per ring row, the block's slot (16
    bytes), then the ring of K/V tiles (f32 rows of hdp + 4 floats; bf16 or
    int8 rows of hdp elements, the f32 tiles they are upcast into and, for
    int8, two scales per ring row)."""
    qp = hdp + 4
    n = 4 * rows * qp + 4 * PAGED_PC * (rows + 4) + 4 * stages * kt + 16
    if elem != 4:
        return (n + stages * 2 * kt * hdp * elem + 4 * 2 * kt * qp
                + (4 * stages * 2 * kt if elem == 1 else 0))
    return n + 4 * stages * 2 * kt * qp


@dataclass(frozen=True)
class PagedPlan:
    """How the paged kernel (K1 / K3) runs one call: ``rows`` flattened
    query rows of a kv group per block, ``key_tile`` key rows per staged
    tile, ``stages`` tiles in its ring, ``splits`` blocks sharing each
    (slot, kv head, row tile)'s keys (more than 1: a merge kernel follows),
    ``vec`` 16-byte staging; ``smem`` bytes of shared memory per block."""
    rows: int
    key_tile: int
    stages: int
    splits: int
    vec: bool
    smem: int

    def c_args(self) -> tuple:
        return (self.rows, self.key_tile, self.stages, self.splits,
                int(self.vec))


def paged_plan(B: int, Sq: int, H: int, KV: int, hd: int, n_keys: int, *,
               elem: int = 4, ptrs: tuple = ()) -> PagedPlan:
    """The plan for B slots of Sq query rows of H heads over KV kv heads of
    width ``hd``, with at most ``n_keys`` = mps * page_size keys a slot,
    over pools of ``elem``-byte elements (4 fp32, 2 bf16, 1 int8); ``ptrs``
    are the data pointers of q, the pools and the output.

    The row tile that pads the group's G * Sq rows least, 64 on a tie (a
    staged key row then serves more query rows). Key tiles of 32 keys, but
    64 for 64 rows of an fp32 pool where a 2-stage ring of them fits (bf16
    and int8 pools keep 32: their three stages then leave room for a
    second block on the SM, which hides the upcasting pass; a decode's
    split gets finer ranges); then 3 stages where they fit. The split over
    keys: one where the (slot, kv head, row tile) blocks fill the SMs (a
    prefill chunk), else as many as give about two blocks per SM (a decode
    tick), at most one per key tile; the kernel divides each slot's live
    key tiles among them on the device. 16-byte staging where every
    pointer is 16-byte aligned and a pool row is a multiple of 16 bytes.
    Raises ``ValueError`` for shapes the kernel cannot take."""
    if not (1 <= KV <= H and H % KV == 0 and 4 <= hd <= MAX_HEAD_DIM
            and hd % 4 == 0 and B >= 1 and Sq >= 1 and n_keys >= 1):
        raise ValueError(f"paged_plan: need H a multiple of KV and head_dim "
                         f"<= {MAX_HEAD_DIM} a multiple of 4, got B={B}, "
                         f"Sq={Sq}, H={H}, KV={KV}, hd={hd}, "
                         f"n_keys={n_keys}")
    n_q, hdp = H // KV * Sq, _head_pad(hd)
    rows = min(PAGED_ROWS, key=lambda r: (_cdiv(n_q, r) * r, -r))
    kt = PAGED_KEY_TILES[1]
    if (rows == PAGED_ROWS[0] and elem == 4 and _paged_smem(
            rows, PAGED_KEY_TILES[0], hdp, 2, elem) <= SMEM_MAX):
        kt = PAGED_KEY_TILES[0]
    stages = 3 if _paged_smem(rows, kt, hdp, 3, elem) <= SMEM_MAX else 2
    pairs = B * KV * _cdiv(n_q, rows)
    splits = 1
    if pairs < SMS:
        splits = max(1, min(_cdiv(n_keys, kt), 2 * SMS // pairs, MAX_SPLITS,
                            65535 // KV))
    vec = all(p % 16 == 0 for p in ptrs) and hd * elem % 16 == 0
    return PagedPlan(rows, kt, stages, splits, vec,
                     _paged_smem(rows, kt, hdp, stages, elem))


def _latent_smem(rows: int, Lw: int, stages: int, elem: int = 4) -> int:
    """Bytes of the latent kernel's shared memory (its ``layout``) over a
    pool of ``elem``-byte elements (4 fp32, 2 bf16): Q and ``stages`` key
    tiles of rows padded to a multiple of the L slices (plus 4 floats of
    pitch), the slices' partial scores, P and the row stats; for bf16 one
    f32 key tile, into which the staged tile is upcast, and a ring of
    ``stages`` bf16 tiles (rows padded by 8 elements)."""
    slices = LATENT_THREADS // rows
    width = slices * _cdiv(_cdiv(Lw, 4), slices) * 4
    lp = width + 4
    kt = LATENT_KEY_TILE
    n = 4 * (rows * lp + (stages if elem == 4 else 1) * kt * lp
             + slices * rows * kt + kt * (rows + 4) + 3 * rows)
    return n if elem == 4 else n + stages * kt * (width + 8) * 2


@dataclass(frozen=True)
class LatentPlan:
    """How the latent kernel runs one call: ``rows`` flattened query rows
    per block, ``stages`` key tiles in its ring, ``splits`` blocks sharing each
    (slot, row tile)'s keys (more than 1: a merge kernel follows), ``vec``
    16-byte staging; ``smem`` bytes of shared memory per block."""
    rows: int
    stages: int
    splits: int
    vec: bool
    smem: int

    def c_args(self) -> tuple:
        return (self.rows, self.stages, self.splits, int(self.vec))


def latent_plan(B: int, n_rows: int, Lw: int, d_v: int, n_keys: int, *,
                q_ptr: int = 0, pool_ptr: int = 0,
                elem: int = 4) -> LatentPlan:
    """The plan for B slots of ``n_rows`` = H * Sq flattened query rows
    over latent rows of ``Lw`` elements of ``elem`` bytes (4 fp32, 2 bf16;
    values: the first ``d_v``) and at most ``n_keys`` = mps * page_size
    keys a slot.

    Of the row tiles whose value columns cover d_v (a row group of 8 rows
    spans 512 / (rows / 8) threads of a float4 column each) and whose
    shared memory fits with a 2-stage ring, the one that pads the rows
    least, 32 on a tie (a staged key row serves more query rows); then 3
    stages where they fit. The split over keys: one where the (slot, row
    tile) pairs fill the SMs (a prefill chunk), else as many as give about
    two blocks per SM (a decode tick), at most one per key tile; the kernel
    divides the key tiles up to each slot's last query among them on the
    device, alike in every row tile. 16-byte staging where q and the pool are 16-byte aligned and Lw is a multiple
    of 16 bytes' elements (4 fp32, 8 bf16). A bf16 pool needs Lw even (its
    narrowest copy is 2 elements)."""
    if not 1 <= d_v <= Lw <= MAX_LATENT_WIDTH:
        raise ValueError(f"latent_plan: need 1 <= d_v <= Lw <= "
                         f"{MAX_LATENT_WIDTH}, got d_v={d_v}, Lw={Lw}")
    if elem == 2 and Lw % 2:
        raise ValueError(f"latent_plan: a bf16 pool needs an even Lw, got "
                         f"{Lw}")
    best = None
    for rows in LATENT_ROWS:
        if (LATENT_THREADS // (rows // 8) * 4 < d_v
                or _latent_smem(rows, Lw, 2, elem) > SMEM_MAX):
            continue
        padded = _cdiv(n_rows, rows) * rows
        if best is None or padded < best[0]:
            best = (padded, rows)
    _, rows = best
    stages = 3 if _latent_smem(rows, Lw, 3, elem) <= SMEM_MAX else 2
    pairs = B * _cdiv(n_rows, rows)
    splits = 1
    if pairs < SMS:
        splits = max(1, min(_cdiv(n_keys, LATENT_KEY_TILE),
                            _cdiv(2 * SMS, pairs), MAX_SPLITS))
    vec = Lw * elem % 16 == 0 and q_ptr % 16 == 0 and pool_ptr % 16 == 0
    return LatentPlan(rows, stages, splits, vec,
                      _latent_smem(rows, Lw, stages, elem))


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib(which: str, q_dtype, pool_dtype):
    """The C entry of kernel ``which`` ('paged', 'q8' or 'latent') for q
    and pools of these dtypes."""
    from repro_torch.kernels import _build
    source = ("paged_attention_latent" if which == "latent"
              else "paged_attention")
    pool = "i8" if pool_dtype == torch.int8 else _DT[pool_dtype]
    stem = "latent_" if which == "latent" else ""
    fn = getattr(_build.load(source),
                 f"repro_paged_attention_{stem}{_DT[q_dtype]}_{pool}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[which]
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
    _check_tables(B, block_tables, start)


def _check_tables(B, block_tables, start):
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(start.shape) != (B,):
        raise ValueError(f"block_tables must be (B, mps) and start (B,) with "
                         f"B={B}; got {tuple(block_tables.shape)}, "
                         f"{tuple(start.shape)}")


def _check_kind(kind: str, suffix: str):
    kinds = ("decode" + suffix, "prefill" + suffix)
    if kind not in kinds:
        raise ValueError(f"kind must be one of {kinds}, got {kind!r}")


def _check_on_card(name, q, named):
    """Every tensor on q's device, of one of its accepted dtypes,
    contiguous."""
    for arg, t, dts in named:
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must share q's device")
        if t.dtype not in dts:
            raise TypeError(f"{name}: {arg} must be one of "
                            f"{[str(d) for d in dts]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _on_cpu(name, tensors) -> bool:
    if tensors[0].is_cuda:
        return False
    if any(t.is_cuda for t in tensors):
        raise ValueError(f"{name}: all tensors must share q's device")
    return True


def paged_attention(q, pool_k, pool_v, block_tables, start, *,
                    window: int = 0, kind: str = "decode", k_scale=None,
                    v_scale=None, plan_heads=None):
    """q: (B, Sq, H, hd) float32 or bfloat16; pool_k/pool_v: (P,
    page_size, KV, hd), float32 or bfloat16, or int8 with
    ``k_scale``/``v_scale`` (P,) float32 per-page symmetric scales;
    block_tables: (B, mps) int32 page ids (-1 = unallocated); start: (B,)
    int32 position of each slot's first query row. Returns (B, Sq, H, hd)
    in q's dtype, computed in fp32. ``kind`` names the caller whose launch
    count the kernel raises ('decode' or 'prefill', with '_q8' for int8
    pools; the key adds :func:`launch_suffix`). ``plan_heads`` = (H, KV)
    of a whole-head call this one is a head slab of: the kernel then runs
    that call's plan (row tile, key tile, stages, splits), so each head
    sums in the order the whole call sums it (see
    :func:`paged_attention_head_sharded`)."""
    _check(q, pool_k, pool_v, block_tables, start)
    quantized = k_scale is not None or v_scale is not None
    _check_kind(kind, "_q8" if quantized else "")
    tensors = (q, pool_k, pool_v, block_tables, start)
    if quantized:
        if k_scale is None or v_scale is None:
            raise ValueError("paged_attention: give k_scale and v_scale "
                             "together")
        P = pool_k.shape[0]
        if tuple(k_scale.shape) != (P,) or tuple(v_scale.shape) != (P,):
            raise ValueError(f"paged_attention: scales must be (P,) = "
                             f"({P},); got {tuple(k_scale.shape)}, "
                             f"{tuple(v_scale.shape)}")
        tensors += (k_scale, v_scale)
    if _on_cpu("paged_attention", tensors):
        return ref.paged_attention(q, pool_k, pool_v, block_tables, start,
                                   window=window, k_scale=k_scale,
                                   v_scale=v_scale)
    which = "q8" if quantized else "paged"
    named = [("q", q, tuple(_DT)), ("pool_k", pool_k, POOL_DTYPES[which]),
             ("pool_v", pool_v, (pool_k.dtype,)),
             ("block_tables", block_tables, (torch.int32,)),
             ("start", start, (torch.int32,))]
    if quantized:
        named += [("k_scale", k_scale, (torch.float32,)),
                  ("v_scale", v_scale, (torch.float32,))]
    _check_on_card("paged_attention", q, named)
    B, Sq, H, hd = q.shape
    P, ps, KV, _ = pool_k.shape
    mps = block_tables.shape[1]
    out = torch.empty_like(q)
    plan_H, plan_KV = plan_heads or (H, KV)
    plan = paged_plan(B, Sq, plan_H, plan_KV, hd, mps * ps,
                      elem=pool_k.element_size(),
                      ptrs=(q.data_ptr(), pool_k.data_ptr(),
                            pool_v.data_ptr(), out.data_ptr()))
    part_o = part_ml = None
    if plan.splits > 1:
        part_o = torch.empty((B, plan.splits, Sq * H, hd),
                             dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B, plan.splits, Sq * H, 2),
                              dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scales = ((k_scale.data_ptr(), v_scale.data_ptr()) if quantized else ())
    with torch.cuda.device(q.device):
        err = _lib(which, q.dtype, pool_k.dtype)(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), *scales,
            block_tables.data_ptr(), start.data_ptr(), out.data_ptr(),
            part_o.data_ptr() if part_o is not None else None,
            part_ml.data_ptr() if part_ml is not None else None,
            B, Sq, H, KV, hd, P, ps, mps, int(window), *plan.c_args(),
            1.0 / math.sqrt(hd), stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES[kind + launch_suffix(q.dtype, pool_k.dtype)] += 1
    return out


def paged_attention_latent(q, pool_c, block_tables, start, *, scale_dim: int,
                           d_v: int, kind: str = "decode_latent",
                           plan_heads=None):
    """MLA attention over latent pages. q: (B, Sq, H, c+r) float32 or
    bfloat16 absorbed queries; pool_c: (P, page_size, 1, c+r) float32 or
    bfloat16 (c+r even), one latent row per token; block_tables / start as
    in :func:`paged_attention`. Scores are scaled by 1/sqrt(``scale_dim``);
    values are the leading ``d_v`` columns of the same rows. Returns (B,
    Sq, H, d_v) in q's dtype, computed in fp32. ``kind``: 'decode_latent'
    or 'prefill_latent' (the key adds :func:`launch_suffix`).
    ``plan_heads``: H of a whole-head call this one is a head slab of, whose
    plan the kernel then runs (see :func:`paged_attention_head_sharded`)."""
    if q.dim() != 4 or pool_c.dim() != 4 or pool_c.shape[2] != 1 \
            or pool_c.shape[3] != q.shape[3]:
        raise ValueError(f"paged_attention_latent wants q (B,Sq,H,L) and a "
                         f"pool (P,ps,1,L); got {tuple(q.shape)}, "
                         f"{tuple(pool_c.shape)}")
    B, Sq, H, Lw = q.shape
    _check_tables(B, block_tables, start)
    _check_kind(kind, "_latent")
    if not 1 <= d_v <= Lw or scale_dim < 1:
        raise ValueError(f"paged_attention_latent: need 1 <= d_v <= {Lw} and "
                         f"scale_dim >= 1, got d_v={d_v}, "
                         f"scale_dim={scale_dim}")
    if _on_cpu("paged_attention_latent", (q, pool_c, block_tables, start)):
        return ref.paged_attention_latent(q, pool_c, block_tables, start,
                                          scale_dim=scale_dim, d_v=d_v)
    _check_on_card("paged_attention_latent", q, [
        ("q", q, tuple(_DT)), ("pool_c", pool_c, POOL_DTYPES["latent"]),
        ("block_tables", block_tables, (torch.int32,)),
        ("start", start, (torch.int32,))])
    if Lw > MAX_LATENT_WIDTH:
        raise ValueError(f"paged_attention_latent kernel takes latent rows "
                         f"of at most {MAX_LATENT_WIDTH} floats, got {Lw}")
    P, ps = pool_c.shape[:2]
    mps = block_tables.shape[1]
    plan = latent_plan(B, (plan_heads or H) * Sq, Lw, d_v, mps * ps,
                       q_ptr=q.data_ptr(),
                       pool_ptr=pool_c.data_ptr(),
                       elem=pool_c.element_size())
    out = torch.empty((B, Sq, H, d_v), dtype=q.dtype, device=q.device)
    part_o = part_ml = None
    if plan.splits > 1:
        part_o = torch.empty((B, plan.splits, H * Sq, d_v),
                             dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B, plan.splits, H * Sq, 2),
                              dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib("latent", q.dtype, pool_c.dtype)(
            q.data_ptr(), pool_c.data_ptr(), block_tables.data_ptr(),
            start.data_ptr(), out.data_ptr(),
            part_o.data_ptr() if part_o is not None else None,
            part_ml.data_ptr() if part_ml is not None else None,
            B, Sq, H, Lw, d_v, P, ps, mps, *plan.c_args(),
            1.0 / math.sqrt(scale_dim), stream)
    if err:
        raise RuntimeError(f"paged_attention_latent kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES[kind + launch_suffix(q.dtype, pool_c.dtype)] += 1
    return out


def paged_attention_head_sharded(mesh, axis, q, pool_k, pool_v, block_tables,
                                 start, *, window: int = 0,
                                 kind: str = "decode", k_scale=None,
                                 v_scale=None):
    """Tensor-parallel head-slab dispatch of :func:`paged_attention`, the
    torch form of the reference's ``shard_map`` wrapper. q: (B, Sq, H, hd),
    every head (the dataflow before attention is replicated); pool_k /
    pool_v: this rank's resident (P, ps, KV / tp, hd) slab of the pool;
    k_scale / v_scale: its (P,) scale column (int8 pools: one scale per
    page per kv-head group, computed from the slab alone). Block tables and
    starts are the replicated ones: page ids are shard-invariant.

    The rank takes its query heads: kv head k and its query heads k * G ..
    k * G + G - 1 stay together, so the slab of heads r * H / tp .. is
    exactly the one its pool slab serves. It launches on them with the
    plan of the whole-head call (``plan_heads``): a slab alone would fill
    fewer blocks and pick more splits over keys, and a head's log-sum-exp
    merge would then round otherwise. With the whole call's plan every
    head sums as the whole call sums it, so the slabs concatenated in rank
    order are the whole call bit for bit. Returns (B, Sq, H / tp, hd); the
    caller all-gathers it before the output projection."""
    from repro_torch.sharding import specs
    tp = specs.mesh_shape(mesh)[axis]
    H = q.shape[2]
    KV = pool_k.shape[2] * tp
    q_loc = q[:, :, specs.head_slab(H, mesh, axis)].contiguous()
    return paged_attention(q_loc, pool_k, pool_v, block_tables, start,
                           window=window, kind=kind, k_scale=k_scale,
                           v_scale=v_scale, plan_heads=(H, KV))


def paged_attention_latent_head_sharded(mesh, axis, q, pool_c, block_tables,
                                        start, *, scale_dim: int, d_v: int,
                                        kind: str = "decode_latent"):
    """Tensor-parallel dispatch of :func:`paged_attention_latent`. The
    latent pool has no kv-head axis and is resident whole on every rank,
    so the split lives on the absorbed queries: the rank launches on its
    query heads r * H / tp .. over the whole pool, with the whole-head
    call's plan (``plan_heads``; the kernel divides each slot's keys among
    its splits alike in every row tile), and returns (B, Sq, H / tp, d_v)
    for the caller to all-gather."""
    from repro_torch.sharding import specs
    H = q.shape[2]
    q_loc = q[:, :, specs.head_slab(H, mesh, axis)].contiguous()
    return paged_attention_latent(q_loc, pool_c, block_tables, start,
                                  scale_dim=scale_dim, d_v=d_v, kind=kind,
                                  plan_heads=H)
