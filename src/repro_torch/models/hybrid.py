"""Hymba, the hybrid-head LM: each layer runs sliding-window GQA attention
and a selective-SSM (mamba) branch in parallel on the same input and
averages the normalized branch outputs (arXiv:2411.13676, meta tokens
omitted). Decode keeps a ring-buffer window KV cache (O(window)) plus the
SSM state. Counterpart of ``repro/models/hybrid.py``: the same parameter
names and layer-stacked shapes and the same operation order; a Python loop
over layers takes the place of ``lax.scan``, and the ring, the page pools
and the recurrent state are written in place. Ring writes ``repro`` drops
(freed slots, unallocated pages) are masked out first.

The selective scan runs through ``scan_impl``: 'pallas' is
``kernels.ops.selective_scan`` (the Hopper kernel on a CUDA tensor), 'scan'
the plain recurrence ``kernels.ref.selective_scan``, 'assoc' the
associative scan in ``jax.lax.associative_scan``'s order, and 'auto' (every
entry point's default) the kernel on the card and, on the CPU, what
``repro`` runs: 'assoc' in a prefill chunk, 'scan' in decode and the
forward.

Inside the sharded steps (``sharding.spmd``) "d_ff" over "model"
(``spmd.tp_keeps``) splits both the MLP and the mamba channels: a rank
runs its D / M channels (its columns of w_in, conv and w_dtB, its rows of
w_out, its entries of dt_bias, logA, d_skip and of the state ``h``: the
selective scan, K6 on the card, on the rank's slab) and its MLP block;
w_dtA, w_B and w_C contract over the split channels and their products
are summed over "model". The attention's heads go over "model" only where
both head counts divide it; otherwise it runs whole. With the residual's
rows over "model" (``spmd.sp_on``) the mamba branch gathers every row
(the scan needs them all) and reduce-scatters w_out's sums back, and the
attention runs the rank's query rows, its band ('banded', or 'chunked'
with the window) on the rank's own K / V rows and a halo of the previous
rank's last ``window`` rows (``layers._banded_rows``) where ``repro``'s
context-parallel form applies. On a replicated residual the band runs
``layers._sdpa_banded_cp``: each rank's own chunks, gathered back.
Outside the step every helper is the identity and the results do not
move by a bit.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.kernels.ref import mask_value
from repro_torch.models import layers as L
from repro_torch.sharding import spmd

DT_RANK = 64
CONV_K = 4
STATE_KEYS = ("h", "conv")


def _attn_dims(cfg: ArchConfig) -> L.AttnDims:
    return L.AttnDims(d_model=cfg.d_model, num_heads=cfg.num_heads,
                      num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                      qkv_bias=False, window=cfg.window,
                      rope_theta=cfg.rope_theta)


def init(cfg: ArchConfig, gen: torch.Generator, device) -> dict:
    """Random weights drawn from ``gen`` on ``device``: ``repro``'s layout,
    scales and constant leaves (the draws themselves differ)."""
    D, Nst = cfg.d_model, cfg.ssm_state
    lead = (cfg.num_layers,)

    def dense(shape, fan_in):
        return L._dense(gen, lead + shape, fan_in, device)

    def const(shape, value):
        return torch.full(lead + shape, value, dtype=torch.float32,
                          device=device)

    layers = {
        "ln1": L.norm_init(D, lead, device, kind=cfg.norm),
        "ln2": L.norm_init(D, lead, device, kind=cfg.norm),
        "attn": L.attn_init(gen, _attn_dims(cfg), lead, device),
        "attn_norm": L.norm_init(cfg.num_heads * cfg.head_dim, lead, device),
        "ssm_norm": L.norm_init(D, lead, device),
        "mlp": L.mlp_init(gen, D, cfg.d_ff, lead, device),
        "w_in": dense((D, D), D),
        "w_out": dense((D, D), D),
        # repro scales a dense init by its first axis: CONV_K here
        "conv": dense((CONV_K, D), CONV_K) * 0.1,
        "w_B": dense((D, Nst), D),
        "w_C": dense((D, Nst), D),
        "w_dtA": dense((D, DT_RANK), D),
        "w_dtB": dense((DT_RANK, D), DT_RANK),
        "dt_bias": const((D,), -4.0),
        "logA": const((D, Nst), 0.0),
        "d_skip": const((D,), 1.0),
    }
    return {
        "embed": L.embed_init(gen, cfg.padded_vocab, D, device),
        "layers": layers,
        "final_norm": L.norm_init(D, device=device, kind=cfg.norm),
        "unembed": {"w": L._dense(gen, (D, cfg.padded_vocab), D, device)},
    }


# ------------------------------------------------------------ SSM branch
def _interleave(even, odd):
    """Rows of ``even`` at 0, 2, 4, ... and of ``odd`` at 1, 3, ... along
    axis 1 (``even`` is as long as ``odd`` or one longer)."""
    out = torch.empty((even.shape[0], even.shape[1] + odd.shape[1])
                      + tuple(even.shape[2:]), dtype=even.dtype,
                      device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _combine(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def _assoc_scan(a, b):
    """``jax.lax.associative_scan`` of ``(a1, b1) o (a2, b2) = (a1 a2,
    a2 b1 + b2)`` along axis 1, by the same odd / even recursion, so the
    products are taken in the reference's order."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = _assoc_scan(*_combine(a[:, :-1:2], b[:, :-1:2], a[:, 1::2],
                                   b[:, 1::2]))
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _ssm_scan_assoc(xin, dt, B_t, C_t, A, h0):
    """The selective scan through the associative scan: ``h_t = a_t
    h_{t-1} + b_t`` with h0 folded into step 0's additive term. Same
    signature and returns as ``ref.selective_scan``."""
    a = torch.exp(A[None, None] * dt[..., None])             # (B,T,D,N)
    b = (dt * xin)[..., None] * B_t[:, :, None, :]           # (B,T,D,N)
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    _, hs = _assoc_scan(a, b)
    y = torch.einsum("btdn,btn->btd", hs, C_t)
    return y, hs[:, -1]


def _mamba_branch(lp, x, cfg: ArchConfig, state, impl: str = "scan"):
    """impl: 'scan', 'assoc', 'pallas' or 'auto' (the kernel on the card,
    'scan' on the CPU).

    Inside the sharded step with the channels over "model"
    (``spmd.tp_split`` of w_in) the rank runs its channels; w_dtA, w_B and
    w_C are read at the rank's rows (``spmd.tp_narrow``) and their products
    summed over "model" in one all-reduce, whose backward all-reduces too
    (every rank's channels read the sums); w_out's rows give a partial
    sum. Given a state, the conv carry (whole over "model" in the cache)
    is read at the rank's channels and the new one gathered back
    (``spmd.tp_gather``).
    Without the rows over "model" x enters through ``spmd.tp_copy``; under
    ``spmd.sp_on`` every row is gathered first and w_out's sums
    reduce-scattered back."""
    sp = spmd.sp_on()
    w_in = lp["w_in"]       # read once: a read gathers it when sharded
    split = spmd.tp_split(w_in) is not None
    if sp:
        x = spmd.sp_gather(x)
    elif split:
        x = spmd.tp_copy(x)
    Bsz, T, _ = x.shape
    impl = L.resolve_scan_impl(impl, x, "scan")
    xin = x @ w_in.to(x.dtype)
    D = xin.shape[-1]       # the rank's channels when split
    # depthwise causal conv over time (kernel CONV_K)
    conv_w = lp["conv"].to(x.dtype)                           # (K, D)
    if state is None:
        tail = torch.zeros((Bsz, CONV_K - 1, D), dtype=x.dtype,
                           device=x.device)
    else:
        tail = state["conv"].to(x.dtype)
        if split:
            tail = tail.narrow(2, spmd.model_rank() * D, D)
    xpad = torch.cat([tail, xin], dim=1)
    xc = L.silu(sum(xpad[:, i:i + T] * conv_w[i] for i in range(CONV_K)))

    xf = xc.float()
    if split:
        rows = [spmd.tp_narrow(lp[k].float(), 0, D)
                for k in ("w_dtA", "w_B", "w_C")]
        sums = spmd.tp_copy(spmd.tp_sum(xf @ torch.cat(rows, dim=1)))
        dt_a, B_t, C_t = (t.contiguous() for t in sums.split(
            [DT_RANK, cfg.ssm_state, cfg.ssm_state], dim=-1))
    else:
        dt_a = xf @ lp["w_dtA"].float()
        B_t = xf @ lp["w_B"].float()
        C_t = xf @ lp["w_C"].float()
    # F.softplus is the identity above 20, where jax's logaddexp(x, 0)
    # differs from x by less than fp32 resolves
    dt = F.softplus(dt_a @ lp["w_dtB"].float() + lp["dt_bias"])
    A = -torch.exp(lp["logA"].float())
    h0 = (state["h"].float() if state is not None
          else torch.zeros((Bsz, D, cfg.ssm_state), dtype=torch.float32,
                           device=x.device))
    if impl == "pallas":
        y, h = kops.selective_scan(xf, dt, B_t, C_t, A, h0)
    elif impl == "assoc":
        y, h = _ssm_scan_assoc(xf, dt, B_t, C_t, A, h0)
    elif impl == "scan":
        y, h = ref.selective_scan(xf, dt, B_t, C_t, A, h0)
    else:
        raise ValueError(f"scan_impl must be 'auto', 'scan', 'assoc' or "
                         f"'pallas', got {impl!r}")
    y = y + lp["d_skip"].float() * xf
    out = y.to(x.dtype) @ lp["w_out"].to(x.dtype)
    if sp:
        out = spmd.sp_scatter(out) if split else spmd.sp_narrow(out)
    elif split:
        out = spmd.tp_sum(out)
    conv = xpad[:, -(CONV_K - 1):].float()
    if state is not None:   # the cache's carry is whole over "model"
        conv = spmd.tp_gather(conv, w_in, 2)
    return out, {"h": h, "conv": conv}


def _combine_branches(cfg: ArchConfig, lp, x, a, s):
    """The residual after the two branches, then the MLP block."""
    a = L.rmsnorm(a, lp["attn_norm"]["scale"])
    s = L.rmsnorm(s, lp["ssm_norm"]["scale"])
    x = x + 0.5 * (a + s)
    return x + L.mlp(lp["mlp"], L.apply_norm(x, lp["ln2"], cfg.norm))


def _layer_apply(cfg: ArchConfig, lp, x, positions, attn_impl, ssm_impl):
    h = L.apply_norm(x, lp["ln1"], cfg.norm)
    a = L.attention(lp["attn"], h, _attn_dims(cfg), positions, impl=attn_impl)
    s, _ = _mamba_branch(lp, h, cfg, None, ssm_impl)
    return _combine_branches(cfg, lp, x, a, s)


def _logits(params, cfg: ArchConfig, x):
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    return L.lm_logits(params["embed"], x, params["unembed"]["w"],
                       vocab=cfg.vocab_size).float()


# ------------------------------------------------------------ public
def forward(params, cfg: ArchConfig, tokens, *, compute_dtype=torch.float32,
            attn_impl: str = "einsum", scan_impl: str = "auto",
            remat=False, return_features: bool = False):
    """tokens: (B, S) at positions 0..S-1 -> (logits (B, S, Vp) float32,
    aux), or (features after the final norm, aux). ``attn_impl`` is
    ``layers.attention``'s ('pallas': the flash kernel with the window).
    ``remat`` checkpoints each layer (``layers.remat``); training runs the
    plain scan (``scan_impl="scan"``): K6 has no backward, as ``repro``'s
    has none. Inside the sharded step with the rows over "model"
    (``spmd.sp_on``) the residual and the features are the rank's rows."""
    B = tokens.shape[0]
    x = L.embed_lookup(params["embed"], tokens, compute_dtype)
    lo, hi = spmd.seq_rows(x.shape[1])    # the rank's rows under sp
    positions = torch.arange(lo, hi, device=tokens.device).expand(B, hi - lo)
    body = L.remat(lambda lp, x: _layer_apply(cfg, lp, x, positions,
                                              attn_impl, scan_impl), remat)
    for i in range(cfg.num_layers):
        x = body(L.layer_params(params["layers"], i), x)
    zero = torch.zeros((), device=x.device)
    aux = {"moe_aux": zero, "moe_z": zero}
    if return_features:
        return L.apply_norm(x, params["final_norm"], cfg.norm), aux
    return _logits(params, cfg, x), aux


def param_logical(cfg: ArchConfig) -> dict:
    """Logical axes of every leaf of ``init``'s params, as ``repro``'s."""
    layer = {
        "ln1": L.norm_logical(cfg.norm), "ln2": L.norm_logical(cfg.norm),
        "attn": L.attn_logical(_attn_dims(cfg)),
        "attn_norm": L.norm_logical("rmsnorm"),
        "ssm_norm": L.norm_logical("rmsnorm"),
        "mlp": L.mlp_logical(gated=True),
        "w_in": ("fsdp", "d_ff"), "w_out": ("d_ff", "fsdp"),
        "conv": (None, "d_ff"),
        "w_B": ("fsdp", None), "w_C": ("fsdp", None),
        "w_dtA": ("fsdp", None), "w_dtB": (None, "d_ff"),
        "dt_bias": ("d_ff",), "logA": ("d_ff", None), "d_skip": ("d_ff",),
    }
    return {"embed": L.embed_logical(),
            "layers": L.stacked_logical(layer),
            "final_norm": L.norm_logical(cfg.norm),
            "unembed": {"w": ("fsdp", "vocab")}}



def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=torch.float32,
               device=None):
    """Ring-buffer window KV cache of W = min(window, s_max) rows with each
    row's absolute position in "slot_pos" (-1 = never written), plus the
    SSM state "h" and the conv carry "conv" (fp32): O(window + state)."""
    W = min(cfg.window, s_max)
    Lr, KV, hd, D = (cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                     cfg.d_model)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "k": torch.zeros((Lr, batch, W, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((Lr, batch, W, KV, hd), dtype=dtype, device=device),
        "slot_pos": torch.full((Lr, batch, W), -1, dtype=torch.int32,
                               device=device),
        "h": torch.zeros((Lr, batch, D, cfg.ssm_state), **f32),
        "conv": torch.zeros((Lr, batch, CONV_K - 1, D), **f32),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_logical(cfg: ArchConfig) -> dict:
    return {"k": (None, "batch", None, "kv_heads", None),
            "v": (None, "batch", None, "kv_heads", None),
            "slot_pos": (None, "batch", None),
            "h": (None, "batch", "d_ff", None),
            "conv": (None, "batch", None, None),
            "pos": ()}


def _ring_sdpa(wo, h, q, ck, cv, valid, dims: L.AttnDims, gather=False):
    """Masked attention over a ring or key view: q (B, Sq, H, hd); ck/cv
    (B, S, KV, hd); valid (B, S) (one query, shared mask) or (B, Sq, S).
    Shared by the dense ring, the paged ring and the prefill chunk.
    ``gather``: q and the view are this rank's head slab under a tensor-
    parallel mesh, and the output is all-gathered before ``wo``."""
    B, Sq = q.shape[:2]
    KV, hd = ck.shape[2], dims.head_dim
    G = dims.num_heads // dims.num_kv_heads
    qg = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg,
                          ck.to(q.dtype)) / math.sqrt(hd)
    if valid.dim() == 2:
        valid = valid[:, None, :]
    scores = torch.where(valid[:, None, None], scores.float(),
                         mask_value(torch.float32))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, cv.to(q.dtype)
                       ).reshape(B, Sq, KV * G * hd)
    if gather:
        out = L._sp.replicate(out)
    return out @ wo.to(h.dtype)


def _window_valid(spos, mask_pos, window: int):
    return (spos >= 0) & (spos <= mask_pos) & (spos > mask_pos - window)


def _window_attn_decode(lp, h, cfg: ArchConfig, ck, cv, slot_pos, pos,
                        positions):
    """Decode attention over the dense ring, written in place. ``pos`` is a
    scalar (lockstep) or a (B,) per-slot vector; a vector's INACTIVE slots
    write nothing, so a finished request's ring stays bit-stable. Inside
    the sharded decode with the heads over "model" the ring holds the
    rank's kv heads: the rank writes and attends its heads, and wo's rows
    give a partial sum (``spmd.tp_sum``)."""
    params, h, dims, tp = L._read_heads(lp["attn"], h, _attn_dims(cfg))
    if tp:
        h = spmd.tp_copy(h)
    q, k, v = L._qkv(params, h, dims, positions)
    W = ck.shape[1]
    if pos.dim() == 1:
        act = pos < L.INACTIVE_POS
        b = torch.arange(q.shape[0], device=q.device)
        slot = torch.where(act, pos % W, 0).long()
        keep = act[:, None, None]
        ck[b, slot] = torch.where(keep, k[:, 0].to(ck.dtype), ck[b, slot])
        cv[b, slot] = torch.where(keep, v[:, 0].to(cv.dtype), cv[b, slot])
        slot_pos[b, slot] = torch.where(act, pos, slot_pos[b, slot])
        mask_pos = pos[:, None]
    else:
        slot = int(pos) % W
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
        slot_pos[:, slot] = pos
        mask_pos = pos
    valid = _window_valid(slot_pos, mask_pos, cfg.window)
    out = _ring_sdpa(params["wo"], h, q, ck, cv, valid, dims)
    return spmd.tp_sum(out) if tp else out


def _window_attn_decode_paged(lp, h, cfg: ArchConfig, pool_k, pool_v,
                              pool_spos, block_tables, ring_w: int, pos,
                              positions):
    """Decode attention over the paged ring: the ring's ``ring_w`` rows
    live in pages reached through per-slot block tables. pool_k/v: (P, ps,
    KV, hd); pool_spos: (P, ps) absolute position per pool row (-1 = never
    written); pos: (B,). The gathered view is the ring in ring order, so
    for equal contents this is the dense ring's arithmetic; rows of
    unallocated pages are masked as never written. Under a tensor-parallel
    mesh the pools are this rank's kv-head slab: it writes and attends its
    heads and all-gathers the output before ``wo``."""
    dims = _attn_dims(cfg)
    q, k, v = L._qkv(lp["attn"], h, dims, positions)
    tp_mesh, tp_axis = L._sp.head_shard_axis(dims.num_heads,
                                             dims.num_kv_heads)
    if tp_mesh is not None:
        kv_slab = L._sp.head_slab(dims.num_kv_heads, tp_mesh, tp_axis)
        k, v = k[:, :, kv_slab], v[:, :, kv_slab]
        q = q[:, :, L._sp.head_slab(dims.num_heads, tp_mesh, tp_axis)]
    ps, KV, hd = pool_k.shape[1:]
    act = pos < L.INACTIVE_POS
    ridx = torch.where(act, pos % ring_w, 0)
    w_row, page_ok = L.paged_write_target(block_tables, ridx, ps)
    w_ok = act & page_ok
    L.paged_write_rows(pool_k, k[:, 0], w_row, w_ok)
    L.paged_write_rows(pool_v, v[:, 0], w_row, w_ok)
    L.paged_write_rows(pool_spos, pos, w_row, w_ok)
    phys, ok = L.paged_row_indices(block_tables, ps, ring_w)
    view_k = pool_k.reshape(-1, KV, hd)[phys]               # (B, W, KV, hd)
    view_v = pool_v.reshape(-1, KV, hd)[phys]
    spos = torch.where(ok, pool_spos.reshape(-1)[phys], -1)
    valid = _window_valid(spos, pos[:, None], cfg.window)
    return _ring_sdpa(lp["attn"]["wo"], h, q, view_k, view_v, valid, dims,
                      gather=tp_mesh is not None)


def _window_attn_prefill_chunk(lp, h, cfg: ArchConfig, ck, cv, slot_pos,
                               positions, use_kernel: bool):
    """Chunk-wide windowed attention against the ring, written in place:
    all C queries attend the pre-chunk ring rows (validity from slot_pos)
    and the chunk's own K/V (causal + window), then the chunk's last
    min(C, W) positions, the rows C sequential ring writes would leave, are
    written into the ring. ``use_kernel`` (a first chunk only, whose ring
    is empty, so chunk-local causal + window is the whole mask) sends the
    attention through the flash kernel with the window."""
    dims = _attn_dims(cfg)
    q, k, v = L._qkv(lp["attn"], h, dims, positions)
    B, C = q.shape[:2]
    W = ck.shape[1]
    if use_kernel:
        out, k, v = kops.flash_prefill(q, k, v, causal=True,
                                       window=cfg.window)
        out = out.reshape(B, C, -1) @ lp["attn"]["wo"].to(h.dtype)
    else:
        keys = torch.cat([ck.to(q.dtype), k], dim=1)             # (B,W+C,.)
        vals = torch.cat([cv.to(q.dtype), v], dim=1)
        kp = torch.cat([slot_pos.long(), positions.long()], dim=1)
        qp = positions.long()[:, :, None]
        valid = ((kp[:, None, :] >= 0) & (kp[:, None, :] <= qp)
                 & (kp[:, None, :] > qp - cfg.window))           # (B,C,W+C)
        out = _ring_sdpa(lp["attn"]["wo"], h, q, keys, vals, valid, dims)
    nw = min(C, W)
    tail_pos = positions[:, C - nw:]
    ridx = (tail_pos % W).long()
    b = torch.arange(B, device=q.device)[:, None]
    ck[b, ridx] = k[:, C - nw:].to(ck.dtype)
    cv[b, ridx] = v[:, C - nw:].to(cv.dtype)
    slot_pos[b, ridx] = tail_pos.to(slot_pos.dtype)
    return out


def _layer_state(cache, i: int):
    return {key: cache[key][i] for key in STATE_KEYS}


def _store_state(cache, i: int, st):
    for key in STATE_KEYS:
        cache[key][i].copy_(st[key])


def _prefill_chunk_layer(cfg: ArchConfig, lp, x, ck, cv, sp, state,
                         positions, use_kernel: bool, ssm_impl: str):
    """One layer over a whole prompt chunk: windowed attention against the
    ring at chunk width (ring written in place) and the mamba branch
    carrying ``state``. Returns (x, new state); ``_decode_layer``'s math."""
    h = L.apply_norm(x, lp["ln1"], cfg.norm)
    a = _window_attn_prefill_chunk(lp, h, cfg, ck, cv, sp, positions,
                                   use_kernel)
    s, st = _mamba_branch(lp, h, cfg, state, ssm_impl)
    return _combine_branches(cfg, lp, x, a, s), st


def prefill_chunk(params, cfg: ArchConfig, tokens, cache, *,
                  compute_dtype=torch.float32, attn_impl: str = "einsum",
                  first: bool = False, scan_impl: str = "auto"):
    """One prompt chunk at full width into a dense ring cache: windowed
    attention against the ring (a ``first`` chunk with ``attn_impl=
    'pallas'`` through the flash kernel), the selective scan through
    ``scan_impl`` ('auto': K6 on the card, ``repro``'s 'assoc' on the CPU),
    the ring and the state left as C sequential ``decode_step`` calls
    would leave them. Returns (last logits (B, 1, Vp) float32, cache with
    ``pos`` advanced by C)."""
    B, C = tokens.shape
    start = 0 if first else int(cache["pos"])
    positions = start + torch.arange(C, device=tokens.device).expand(B, C)
    use_kernel = first and attn_impl == "pallas"
    x = L.embed_lookup(params["embed"], tokens, compute_dtype)
    impl = L.resolve_scan_impl(scan_impl, x, "assoc")
    for i in range(cfg.num_layers):
        x, st = _prefill_chunk_layer(
            cfg, L.layer_params(params["layers"], i), x, cache["k"][i],
            cache["v"][i], cache["slot_pos"][i], _layer_state(cache, i),
            positions, use_kernel, impl)
        _store_state(cache, i, st)
    cache["pos"] = torch.tensor(start + C, dtype=torch.int32,
                                device=tokens.device)
    return _logits(params, cfg, x[:, -1:]), cache


def _decode_layer(cfg: ArchConfig, lp, x, ck, cv, sp, state, pos, positions,
                  block_tables=None, ring_w: int = 0, ssm_impl="auto"):
    """One decode layer (windowed ring attention and the SSM state); with
    ``block_tables``, ck/cv/sp are one layer's page-pool slices and the
    attention reads the paged ring. Returns (x, new state), freed slots'
    state kept bit for bit."""
    h = L.apply_norm(x, lp["ln1"], cfg.norm)
    if block_tables is not None:
        a = _window_attn_decode_paged(lp, h, cfg, ck, cv, sp, block_tables,
                                      ring_w, pos, positions)
    else:
        a = _window_attn_decode(lp, h, cfg, ck, cv, sp, pos, positions)
    s, st = _mamba_branch(lp, h, cfg, state, ssm_impl)
    st = L.freeze_inactive_rows(pos, st, state)
    return _combine_branches(cfg, lp, x, a, s), st


def decode_step(params, cfg: ArchConfig, token, cache, *,
                compute_dtype=torch.float32, paged_attn_impl: str = "einsum",
                scan_impl: str = "auto"):
    """token: (B, 1). Returns (logits (B, 1, Vp) float32, cache with
    ``pos`` advanced by one), written in place. A cache with
    "block_tables" is the paged ring (registry.init_paged_cache): "k" /
    "v" / "slot_pos" are page pools and the (W,) "ring_iota" leaf's length
    is the ring width. The paged ring is read by the masked einsum only
    (the hybrid family is not one of the paged kernel's)."""
    if paged_attn_impl != "einsum":
        raise ValueError(f"the hybrid ring reads its pages by the masked "
                         f"einsum only, got paged_attn_impl="
                         f"{paged_attn_impl!r}")
    B = token.shape[0]
    pos = cache["pos"]
    bt = cache.get("block_tables")
    ring_w = cache["ring_iota"].shape[0] if bt is not None else 0
    positions = L.decode_positions(pos, B)
    x = L.embed_lookup(params["embed"], token, compute_dtype)
    for i in range(cfg.num_layers):
        x, st = _decode_layer(cfg, L.layer_params(params["layers"], i), x,
                              cache["k"][i], cache["v"][i],
                              cache["slot_pos"][i], _layer_state(cache, i),
                              pos, positions, bt, ring_w, scan_impl)
        _store_state(cache, i, st)
    cache["pos"] = pos + 1
    return _logits(params, cfg, x), cache
