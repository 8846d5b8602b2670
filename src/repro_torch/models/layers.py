"""Model layers of the port: norms, RoPE, the QKV projection, full-sequence
attention (einsum, chunked, banded, flash kernel), decode and prefill-chunk
attention against a dense or a paged KV cache, the gated MLP, embeddings
and logits. Counterpart of the same-named functions in
``repro/models/layers.py`` (same argument layouts and operation order);
parameters are dicts of tensors.

Where ``repro`` returns a functionally updated cache or page pool
(``dynamic_update_slice``, ``.at[].set(mode="drop")``), the port writes it
IN PLACE and returns the same tensor. Rows that JAX would drop (freed
slots, unallocated pages, rows below a prefix write floor) are removed by
masking first, because ``index_put_`` does not drop out-of-range indices,
and a slice start is clamped as ``dynamic_update_slice`` clamps it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import mask_value


def rmsnorm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dtype)


def norm_init(d: int, lead=(), device=None):
    """rmsnorm scale, stored as the offset from 1 (zeros = identity)."""
    return {"scale": torch.zeros(tuple(lead) + (d,), device=device)}


# ---------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S). Half-split rotation with
    fp32 angles."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., :, None].float() * freqs        # (..., S, hd/2)
    sin = torch.sin(angles)[..., :, None, :]                # broadcast heads
    cos = torch.cos(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- init
def _dense(gen, shape, fan_in: int, device=None):
    return torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    window: int = 0          # 0 = full causal
    rope_theta: float = 10000.0
    causal: bool = True


def attn_init(gen, dims: AttnDims, lead=(), device=None):
    """Attention weights with leading axes ``lead`` (the layer stack)."""
    D, H, KV, hd = dims.d_model, dims.num_heads, dims.num_kv_heads, dims.head_dim
    lead = tuple(lead)
    p = {"wq": _dense(gen, lead + (D, H * hd), D, device),
         "wk": _dense(gen, lead + (D, KV * hd), D, device),
         "wv": _dense(gen, lead + (D, KV * hd), D, device),
         "wo": _dense(gen, lead + (H * hd, D), H * hd, device)}
    if dims.qkv_bias:
        p["bq"] = torch.zeros(lead + (H * hd,), device=device)
        p["bk"] = torch.zeros(lead + (KV * hd,), device=device)
        p["bv"] = torch.zeros(lead + (KV * hd,), device=device)
    return p


def mlp_init(gen, d_model: int, d_ff: int, lead=(), device=None):
    """Gated-SiLU MLP weights with leading axes ``lead``."""
    lead = tuple(lead)
    return {"w_up": _dense(gen, lead + (d_model, d_ff), d_model, device),
            "w_down": _dense(gen, lead + (d_ff, d_model), d_ff, device),
            "w_gate": _dense(gen, lead + (d_model, d_ff), d_model, device)}


def embed_init(gen, padded_vocab: int, d_model: int, device=None):
    return {"table": torch.randn((padded_vocab, d_model), generator=gen,
                                 device=device) * 0.02}


# ---------------------------------------------------------------- attention
def _qkv(params, x, dims: AttnDims, positions):
    B, S, _ = x.shape
    H, KV, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if dims.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if dims.rope_theta > 0:
        q = apply_rope(q, positions, dims.rope_theta)
        k = apply_rope(k, positions, dims.rope_theta)
    return q, k, v


def _mask_bias(q_pos, k_pos, window: int, causal: bool):
    """(..., Sq, Sk) additive float32 mask from absolute positions: 0 where
    a key is visible, ``mask_value`` where it is not."""
    diff = q_pos[..., :, None].long() - k_pos[..., None, :].long()
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if window > 0:
        ok &= diff < window
    return torch.where(ok, 0.0, mask_value(torch.float32)).float()


def _sdpa_einsum(q, k, v, q_pos, k_pos, dims: AttnDims):
    """Reference attention. q: (B,Sq,H,hd); k, v: (B,Sk,KV,hd). GQA K/V are
    repeated to H heads, as ``repro`` does, so every tensor carries one
    head axis."""
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    scores = torch.einsum("bqhe,bshe->bhqs", q, k).float() / math.sqrt(hd)
    scores = scores + _mask_bias(q_pos, k_pos, dims.window,
                                 dims.causal)[:, None]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshe->bqhe", probs, v)


def _sdpa_chunked(q, k, v, q_pos, k_pos, dims: AttnDims, q_chunk: int = 1024):
    """``_sdpa_einsum`` over query chunks of about ``q_chunk`` rows, which
    bounds live memory to O(q_chunk * Sk). ``repro`` checkpoints each chunk
    for its backward pass; without autograd a loop is the whole of it."""
    B, Sq, H, hd = q.shape
    n_chunks = max(1, Sq // q_chunk)
    q_chunk = Sq // n_chunks
    qs = q.reshape(B, n_chunks, q_chunk, H, hd)
    qp = q_pos.reshape(B, n_chunks, q_chunk)
    return torch.cat([_sdpa_einsum(qs[:, c], k, v, qp[:, c], k_pos, dims)
                      for c in range(n_chunks)], dim=1)


def _sdpa_banded(q, k, v, dims: AttnDims, q_chunk: int = 1024):
    """Sliding-window attention over the diagonal band only: each query
    chunk attends key rows [chunk_start - window, chunk_end), so the work is
    O(S * (window + chunk)). Positions are the row indices (0..S-1)."""
    B, Sq, H, hd = q.shape
    W = dims.window
    n_chunks = max(1, Sq // q_chunk)
    q_chunk = Sq // n_chunks
    dev = q.device
    outs = []
    for ci in range(n_chunks):
        qs = ci * q_chunk
        ks = max(0, qs - W)
        ke = qs + q_chunk
        q_pos = torch.arange(qs, qs + q_chunk, device=dev).expand(B, q_chunk)
        k_pos = torch.arange(ks, ke, device=dev).expand(B, ke - ks)
        outs.append(_sdpa_einsum(q[:, qs:qs + q_chunk], k[:, ks:ke],
                                 v[:, ks:ke], q_pos, k_pos, dims))
    return torch.cat(outs, dim=1)


def attention(params, x, dims: AttnDims, positions, impl: str = "einsum"):
    """Full-sequence self-attention. ``impl``: 'einsum' (the reference),
    'chunked' (query chunks; the band only for a causal window), 'banded'
    or 'pallas' (the flash-attention kernel, ``kernels.ops``). Without a
    mesh ``repro``'s context-parallel banded form is the banded one, which
    is what runs here (ROADMAP queue 1 item 12 ports the mesh form)."""
    q, k, v = _qkv(params, x, dims, positions)
    k_pos = positions
    if impl == "banded" or (impl == "chunked" and dims.window > 0
                            and dims.causal):
        out = _sdpa_banded(q, k, v, dims)
    elif impl == "chunked":
        out = _sdpa_chunked(q, k, v, positions, k_pos, dims)
    elif impl == "pallas":
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, k, v, causal=dims.causal,
                                   window=dims.window, q_positions=positions,
                                   k_positions=k_pos)
    else:
        out = _sdpa_einsum(q, k, v, positions, k_pos, dims)
    B, S, H, hd = out.shape
    return out.reshape(B, S, H * hd) @ params["wo"].to(x.dtype)


# Sentinel cache position of an INACTIVE (freed / never-admitted) serving
# slot: >= any reachable position, so every cache write from such a slot is
# dropped and freed rows stay bit-stable.
INACTIVE_POS = 1 << 30


def decode_positions(pos, batch: int):
    """(B, 1) query positions from a cache ``pos`` that is a scalar
    (lockstep batch) or a (B,) per-slot vector."""
    if pos.dim() == 1:
        return pos[:, None]
    return torch.full((batch, 1), int(pos), dtype=torch.int64,
                      device=pos.device)


def _decode_sdpa_local(q, ck, cv, cache_pos, k_positions, window, hd):
    """Partial-softmax decode attention: q (B,1,KV,G,hd); ck/cv
    (B,S,KV,hd); k_positions (B,S); cache_pos (B,1). Returns
    (l (B,KV,G,1), acc (B,KV,G,1,hd))."""
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, ck.to(q.dtype)
                          ).float() / math.sqrt(hd)
    valid = k_positions <= cache_pos
    if window > 0:
        valid &= k_positions > cache_pos - window
    scores = torch.where(valid[:, None, None, None, :], scores,
                         mask_value(scores.dtype))
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqs,bskh->bkgqh", p.to(q.dtype),
                       cv.to(q.dtype)).float()
    return l, acc


def _write_row(cache, rows, cache_pos):
    """The dense decode write, in place: rows (B, KV, hd) land at
    ``cache[b, cache_pos[b]]`` for a (B,) vector (an out-of-range position,
    a freed slot's, is dropped as ``.at[].set(mode="drop")`` drops it), or
    at ``cache[:, cache_pos]`` for an int, clamped into range as
    ``dynamic_update_slice`` clamps its start."""
    S = cache.shape[1]
    if isinstance(cache_pos, int):
        cache[:, min(max(cache_pos, 0), S - 1)] = rows.to(cache.dtype)
        return
    b = torch.arange(cache.shape[0], device=cache.device)
    pos = cache_pos.long()
    ok = ((pos >= 0) & (pos < S))[:, None, None]
    idx = pos.clamp(0, S - 1)
    cache[b, idx] = torch.where(ok, rows.to(cache.dtype), cache[b, idx])


def attention_decode(params, x, dims: AttnDims, cache_k, cache_v, cache_pos,
                     positions):
    """Single-token decode against a dense cache, written IN PLACE.

    x: (B, 1, D); cache_k/cache_v: (B, S_max, KV, hd), one layer's slice;
    cache_pos: a (B,) tensor of per-slot positions (the serving engine) or
    a scalar (the lockstep scan prefill). The new K/V row is written at
    each slot's position, then rows at positions <= cache_pos (and inside
    the window) are attended. Returns (out, cache_k, cache_v)."""
    q, k, v = _qkv(params, x, dims, positions)
    B, S_max, KV, hd = cache_k.shape
    G = dims.num_heads // KV
    if cache_pos.dim() == 0:
        cache_pos = int(cache_pos)
        mask_pos = cache_pos
    else:
        mask_pos = cache_pos.long()[:, None]
    _write_row(cache_k, k[:, 0], cache_pos)
    _write_row(cache_v, v[:, 0], cache_pos)
    k_positions = torch.arange(S_max, device=x.device)[None, :]
    l, acc = _decode_sdpa_local(q.reshape(B, 1, KV, G, hd), cache_k, cache_v,
                                mask_pos, k_positions, dims.window, hd)
    out = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, 1, dims.num_heads * hd)
    return out @ params["wo"].to(x.dtype), cache_k, cache_v


def attention_prefill_chunk(params, x, dims: AttnDims, cache_k, cache_v,
                            start: int, positions, use_kernel: bool = False):
    """Prefill-chunk attention against a dense per-request cache, written
    IN PLACE.

    x: (B, C, D); cache_k/cache_v: (B, S_max, KV, hd); ``start``: the
    chunk's first position (clamped into range as ``dynamic_update_slice``
    clamps it); positions: (B, C). The chunk's post-RoPE K/V land in rows
    [start, start + C); all C queries then attend every row at a position
    <= theirs. ``use_kernel`` sends the attention through the flash kernel
    (``kernels.ops.flash_prefill``), which is right only for a first chunk
    (start == 0), where chunk-local causal attention is the whole mask.
    Returns (out (B, C, D), cache_k, cache_v)."""
    q, k, v = _qkv(params, x, dims, positions)
    B, C, KV, hd = k.shape
    H = dims.num_heads
    S_max = cache_k.shape[1]
    s = min(max(int(start), 0), S_max - C)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        out, k, v = kops.flash_prefill(q, k, v, causal=dims.causal,
                                       window=dims.window)
        out = out.reshape(B, C, H * hd)
    cache_k[:, s:s + C] = k.to(cache_k.dtype)
    cache_v[:, s:s + C] = v.to(cache_v.dtype)
    if not use_kernel:
        qg = q.reshape(B, C, KV, H // KV, hd)
        scores = torch.einsum("bqkgh,bskh->bkgqs", qg, cache_k.to(q.dtype)
                              ).float() / math.sqrt(hd)
        k_pos = torch.arange(S_max, device=x.device)
        valid = k_pos[None, None, :] <= positions[:, :, None]      # (B,C,S)
        if dims.window > 0:
            valid &= k_pos[None, None, :] > positions[:, :, None] - dims.window
        scores = torch.where(valid[:, None, None, :, :], scores,
                             mask_value(scores.dtype))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bkgqs,bskh->bqkgh", probs, cache_v.to(q.dtype)
                           ).reshape(B, C, H * hd)
    return out @ params["wo"].to(x.dtype), cache_k, cache_v


# ------------------------------------------------------- paged KV
def paged_row_indices(block_tables, page_size: int, n_rows: int):
    """Flattened pool-row index (int64) of each LOGICAL row of every slot,
    plus the page-allocated mask. Rows of unallocated pages map to 0."""
    j = torch.arange(n_rows, device=block_tables.device)
    page = block_tables.long()[:, j // page_size]
    ok = page >= 0
    phys = torch.where(ok, page * page_size + j[None, :] % page_size, 0)
    return phys, ok


def paged_write_target(block_tables, idx, page_size: int):
    """Write-side block-table lookup: idx (B,) logical row per slot (>= 0).
    Returns ((B,) flattened pool row, (B,) bool page allocated)."""
    mps = block_tables.shape[1]
    idx = idx.long()
    page = torch.gather(block_tables.long(), 1,
                        (idx // page_size).clamp(0, mps - 1)[:, None])[:, 0]
    return page * page_size + idx % page_size, page >= 0


def paged_write_rows(pool, rows, row_idx, valid):
    """Write one new row per slot into a page pool IN PLACE.
    pool: (P, ps, ...); rows: (B, ...); row_idx: (B,) flattened pool row;
    valid: (B,) bool — invalid writes (freed slots, unallocated pages) are
    dropped. Returns ``pool``."""
    P, ps = pool.shape[:2]
    flat = pool.view((P * ps,) + tuple(pool.shape[2:]))
    flat[row_idx[valid]] = rows[valid].to(flat.dtype)
    return pool


def attention_decode_paged(params, x, dims: AttnDims, pool_k, pool_v,
                           block_tables, cache_pos, positions,
                           impl: str = "einsum"):
    """Single-token decode against a PAGED KV cache.

    x: (B,1,D); pool_k/pool_v: (P, page_size, KV, hd), one layer's slice of
    the shared pool; block_tables: (B, mps) int32, -1 = unallocated;
    cache_pos: (B,) per-slot positions. The new K/V row is written in place
    at page block_tables[b, pos // ps], offset pos % ps; writes from slots
    whose position is out of range (freed slots at INACTIVE_POS) or whose
    page is unallocated are dropped. ``impl='kernel'`` reads through the
    paged-attention kernel (``kernels.ops.paged_decode``); ``'einsum'`` is
    the masked-gather reference over the full block-table span. Returns
    (out, pool_k, pool_v)."""
    q, k, v = _qkv(params, x, dims, positions)
    P, ps, KV, hd = pool_k.shape
    B = q.shape[0]
    mps = block_tables.shape[1]
    n_rows = mps * ps
    H = dims.num_heads
    G = H // KV

    pos = cache_pos.long()
    w_row, page_ok = paged_write_target(block_tables, pos.clamp(0, n_rows - 1),
                                        ps)
    w_ok = (pos >= 0) & (pos < n_rows) & page_ok
    paged_write_rows(pool_k, k[:, 0], w_row, w_ok)
    paged_write_rows(pool_v, v[:, 0], w_row, w_ok)

    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        out = kops.paged_decode(q, pool_k, pool_v,
                                block_tables.int().contiguous(),
                                cache_pos.int().contiguous(),
                                window=dims.window)
        out = out.reshape(B, 1, H * hd)
    else:
        qg = q.reshape(B, 1, KV, G, hd)
        phys, ok = paged_row_indices(block_tables, ps, n_rows)
        view_k = pool_k.reshape(P * ps, KV, hd)[phys]   # (B, n_rows, KV, hd)
        view_v = pool_v.reshape(P * ps, KV, hd)[phys]
        k_positions = torch.where(
            ok, torch.arange(n_rows, device=x.device)[None, :], INACTIVE_POS)
        l, acc = _decode_sdpa_local(qg, view_k, view_v, pos[:, None],
                                       k_positions, dims.window, hd)
        out = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
        out = out.permute(0, 3, 1, 2, 4).reshape(B, 1, H * hd)
    return out @ params["wo"].to(x.dtype), pool_k, pool_v


def attention_prefill_chunk_paged(params, x, dims: AttnDims, pool_k, pool_v,
                                  block_tables, positions, write_floor: int,
                                  impl: str = "kernel"):
    """Prefill-chunk attention directly against the paged pool.

    x: (B, C, D); pool_k/pool_v: one layer's (P, ps, KV, hd) pool slice;
    block_tables: (B, mps); positions: (B, C) absolute query positions
    (contiguous, sharing a start); write_floor: the first logical row this
    group may write. The chunk's post-RoPE K/V rows are written in place
    into the slots' pages; rows below ``write_floor`` (shared immutable
    prefix pages) are dropped. Attention then reads prior chunks, aliased
    prefix pages and the chunk itself through the block table
    (``impl='kernel'``: ``ops.paged_prefill``; ``'einsum'``: masked gather).
    Returns (out (B, C, D), pool_k, pool_v)."""
    q, k, v = _qkv(params, x, dims, positions)
    B, C, KV, hd = k.shape
    P, ps = pool_k.shape[:2]
    mps = block_tables.shape[1]
    n_rows = mps * ps
    H = dims.num_heads

    pos = positions.long()
    page = torch.gather(block_tables.long(), 1, (pos // ps).clamp(0, mps - 1))
    w_ok = ((page >= 0) & (pos >= write_floor) & (pos >= 0)
            & (pos < n_rows))
    w_rows = (page * ps + pos % ps)[w_ok]
    flat_k = pool_k.view(P * ps, KV, hd)
    flat_v = pool_v.view(P * ps, KV, hd)
    flat_k[w_rows] = k[w_ok].to(flat_k.dtype)
    flat_v[w_rows] = v[w_ok].to(flat_v.dtype)

    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        out = kops.paged_prefill(q, pool_k, pool_v,
                                 block_tables.int().contiguous(),
                                 positions[:, 0].int().contiguous(),
                                 window=dims.window)
        out = out.reshape(B, C, H * hd)
    else:
        G = H // KV
        qg = q.reshape(B, C, KV, G, hd)
        phys, ok = paged_row_indices(block_tables, ps, n_rows)
        view_k = flat_k[phys]                          # (B, n_rows, KV, hd)
        view_v = flat_v[phys]
        scores = torch.einsum("bqkgh,bskh->bkgqs", qg, view_k.to(q.dtype)
                              ).float() / math.sqrt(hd)
        k_pos = torch.where(ok, torch.arange(n_rows, device=x.device)[None, :],
                            INACTIVE_POS)
        valid = k_pos[:, None, :] <= pos[:, :, None]            # (B,C,S)
        if dims.window > 0:
            valid &= k_pos[:, None, :] > pos[:, :, None] - dims.window
        scores = torch.where(valid[:, None, None, :, :], scores,
                             mask_value(scores.dtype))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bkgqs,bskh->bqkgh", probs, view_v.to(q.dtype)
                           ).reshape(B, C, H * hd)
    return out @ params["wo"].to(x.dtype), pool_k, pool_v


# ---------------------------------------------------------------- MLP
def mlp(params, x):
    """Gated SiLU MLP: (silu(x @ w_gate) * (x @ w_up)) @ w_down."""
    up = x @ params["w_up"].to(x.dtype)
    gate = x @ params["w_gate"].to(x.dtype)
    return (F.silu(gate) * up) @ params["w_down"].to(x.dtype)


# ---------------------------------------------------------------- embeddings
def embed_lookup(params, ids, dtype):
    return params["table"].to(dtype)[ids]


def lm_logits(params_embed, x, w_unembed=None, vocab: Optional[int] = None):
    """x: (B,S,D) -> (B,S,V_padded), padding columns masked. Uses the tied
    embedding table if w_unembed is None."""
    if w_unembed is None:
        logits = x @ params_embed["table"].to(x.dtype).T
    else:
        logits = x @ w_unembed.to(x.dtype)
    vp = logits.shape[-1]
    if vocab is not None and vocab < vp:
        keep = torch.arange(vp, device=x.device) < vocab
        logits = torch.where(keep, logits, mask_value(logits.dtype))
    return logits
