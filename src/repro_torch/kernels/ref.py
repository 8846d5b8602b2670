"""Plain PyTorch versions of the port's kernels (paged attention over fp32
and int8 pools, latent paged attention, flash attention, the tiled GEMM,
the int8-weight GEMM, the RWKV6 wkv recurrence and the mamba selective
scan): the ground truth
each kernel is held against on the card, and the path a wrapper takes for
tensors that lie on the CPU. Also home to :func:`mask_value`, the shared
masking sentinel, and :func:`mla_attention_naive`, the oracle of the MLA
absorb path. Counterpart of ``repro/kernels/ref.py``."""
from __future__ import annotations

import math

import torch


def mask_value(dtype: torch.dtype) -> float:
    """Finite large-negative sentinel for where-masking in ``dtype``: -1e30
    where representable (float32/bfloat16), else half the dtype's minimum
    (float16 would overflow -1e30 to -inf and turn a fully-masked softmax
    row into NaN)."""
    fi = torch.finfo(dtype)
    if float(fi.max) > 1e30:
        return -1e30
    return float(fi.min) / 2


def matmul(a, b):
    """a: (M, K), b: (K, N) -> (M, N) in a's dtype, f32 accumulation."""
    return (a.float() @ b.float()).to(a.dtype)


def quant_matmul(a, w_q, scales):
    """a: (M, K) float; w_q: (K, N) int8; scales: (N,) per-output-channel.
    out = a @ (w_q * scales) with f32 accumulation: the weight is
    dequantized first, element by element, then multiplied."""
    w = w_q.float() * scales.float()[None, :]
    return (a.float() @ w).to(a.dtype)


def paged_attention(q, pool_k, pool_v, block_tables, start, *, window=0,
                    k_scale=None, v_scale=None):
    """Plain version of the paged-attention kernel: gather each slot's
    logical view through its block table and run a masked softmax.

    q: (B, Sq, H, hd); pool_k/pool_v: (P, ps, KV, hd); block_tables:
    (B, mps) int32 (-1 = unallocated); start: (B,) int32 first query
    position per slot (query row i is at start[b] + i; logical key row r
    lives in page r // ps at offset r % ps). Masked probabilities are
    zeroed, so a query row with no valid key anywhere (a freed slot with an
    all--1 block table) returns exactly 0, like the kernel's l == 0 guard.

    k_scale/v_scale: the int8 pools' f32 per-page symmetric scales, (P,)
    or (P, T) with group t covering the contiguous KV/T kv heads; the
    gathered view is dequantized page by page before the softmax, as the
    int8 kernel dequantizes each page it gathers.

    q may be fp32 or bf16 and the pools fp32, bf16 or int8 in any pairing:
    like the Pallas kernels, every operand is upcast to fp32, the scores,
    p and the sums stay fp32, and the output is rounded once, to q's
    dtype. (``repro.kernels.ref`` rounds K, V and p to q's dtype, which in
    bf16 is not the kernels' function; in fp32 the two are the same.)"""
    B, Sq, H, hd = q.shape
    P, ps, KV, _ = pool_k.shape
    mps = block_tables.shape[1]
    G = H // KV
    n_rows = mps * ps
    dev = q.device
    j = torch.arange(n_rows, device=dev)
    page = block_tables.long()[:, j // ps]                  # (B, n_rows)
    ok = page >= 0
    phys = torch.where(ok, page * ps + j % ps, 0)
    view_k = pool_k.reshape(P * ps, KV, hd)[phys]          # (B, n_rows, KV, hd)
    view_v = pool_v.reshape(P * ps, KV, hd)[phys]
    if k_scale is not None:
        pg = torch.where(ok, page, 0)
        ks, vs = k_scale[pg], v_scale[pg]       # (B, n_rows) or (..., T)
        if ks.dim() == 2:
            ks, vs = ks[..., None], vs[..., None]
        rep = KV // ks.shape[-1]                # heads per scale group
        ks = ks.repeat_interleave(rep, dim=-1)  # (B, n_rows, KV)
        vs = vs.repeat_interleave(rep, dim=-1)
        view_k = view_k.float() * ks[..., None]
        view_v = view_v.float() * vs[..., None]
    q_pos = start.long()[:, None] + torch.arange(Sq, device=dev)[None, :]
    valid = ok[:, None, :] & (j[None, None, :] <= q_pos[:, :, None])
    if window > 0:
        valid &= j[None, None, :] > q_pos[:, :, None] - window
    # one (G * Sq, hd) @ (hd, n_rows) product per (slot, kv head), with
    # the keys copied to (hd, n_rows) rows whatever KV is: with one kv head
    # a transposed view would serve, and a product on that layout rounds
    # otherwise, so a head slab (tensor parallelism) would not give the
    # same heads of the whole call bit for bit
    qg = q.float().reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)
    kt = view_k.float().permute(0, 2, 3, 1).reshape(B * KV, hd, n_rows)
    s = torch.bmm(qg.reshape(B * KV, G * Sq, hd), kt.contiguous()).reshape(
        B, KV, G, Sq, n_rows) / math.sqrt(hd)
    vm = valid[:, None, None, :, :]
    s = torch.where(vm, s, mask_value(s.dtype))
    m = s.amax(dim=-1)
    p = torch.where(vm, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    vk = view_v.float().permute(0, 2, 1, 3).reshape(B * KV, n_rows, hd)
    acc = torch.bmm(p.reshape(B * KV, G * Sq, n_rows), vk.contiguous())
    acc = acc.reshape(B, KV, G, Sq, hd)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]         # (B,KV,G,Sq,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def paged_attention_latent(q, pool_c, block_tables, start, *, scale_dim,
                           d_v):
    """Plain version of the latent paged-attention kernel (MLA): gather
    each slot's latent rows through its block table and run a masked
    softmax in latent space.

    q: (B, Sq, H, c+r) absorbed queries; pool_c: (P, ps, 1, c+r), one
    latent row per token shared by every head (values are the leading
    ``d_v`` columns of the same rows). Scores divide by
    sqrt(``scale_dim``), the logical head width, not the latent width.
    Masked probabilities are zeroed, so a freed slot returns exactly 0.
    Returns (B, Sq, H, d_v), still in latent space. q and the pool may be
    fp32 or bf16: computed in fp32 and rounded once to q's dtype, as
    :func:`paged_attention`."""
    B, Sq, H, Lw = q.shape
    P, ps = pool_c.shape[:2]
    mps = block_tables.shape[1]
    n_rows = mps * ps
    dev = q.device
    j = torch.arange(n_rows, device=dev)
    page = block_tables.long()[:, j // ps]
    ok = page >= 0
    phys = torch.where(ok, page * ps + j % ps, 0)
    view = pool_c.reshape(P * ps, Lw)[phys]                 # (B, n_rows, c+r)
    q_pos = start.long()[:, None] + torch.arange(Sq, device=dev)[None, :]
    valid = ok[:, None, :] & (j[None, None, :] <= q_pos[:, :, None])
    # one (Sq, Lw) @ (Lw, n_rows) product per (slot, head): a product over
    # the rows of several heads rounds its sums by how many rows it has, so
    # a head slab (tensor parallelism) would not give the same heads of the
    # whole call bit for bit
    kt = view.float().transpose(1, 2).contiguous()          # (B, Lw, n_rows)
    vv = view[..., :d_v].float().contiguous()               # (B, n_rows, d_v)
    qf = q.float()
    s = torch.stack([torch.bmm(qf[:, :, h].contiguous(), kt)
                     for h in range(H)], dim=1) / math.sqrt(scale_dim)
    vm = valid[:, None, :, :]
    s = torch.where(vm, s, mask_value(s.dtype))
    m = s.amax(dim=-1)
    p = torch.where(vm, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.stack([torch.bmm(p[:, h].contiguous(), vv)
                       for h in range(H)], dim=1)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]         # (B, H, Sq, d_v)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def mla_attention_naive(q_nope, q_pe, latent, wb_k, wb_v, q_positions,
                        k_positions):
    """The MLA oracle by naive expansion: per-head K/V materialised from
    the latent rows, then ordinary attention. The absorb path (wkv_b folded
    into the query and output einsums) must stay allclose to it.

    q_nope: (B, Sq, H, hd) queries before absorption; q_pe: (B, Sq, H, r)
    RoPE'd decoupled queries; latent: (B, Sk, c + r) cached rows; wb_k:
    (H, hd, c), wb_v: (H, c, hd), the halves of wkv_b. Returns
    (B, Sq, H, hd), the per-head output before ``wo``."""
    hd = q_nope.shape[-1]
    r = q_pe.shape[-1]
    c = latent.shape[-1] - r
    ck, k_pe = latent[..., :c], latent[..., c:]
    k_nope = torch.einsum("bsc,hdc->bshd", ck, wb_k)
    v = torch.einsum("bsc,hcd->bshd", ck, wb_v)
    s = (torch.einsum("bqhd,bshd->bhqs", q_nope, k_nope)
         + torch.einsum("bqhr,bsr->bhqs", q_pe, k_pe)
         ).float() / math.sqrt(hd + r)
    diff = (q_positions.long()[:, None, :, None]
            - k_positions.long()[:, None, None, :])
    s = torch.where(diff >= 0, s, mask_value(s.dtype))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p, v)


def flash_attention(q, k, v, *, causal=True, window=0, q_positions=None,
                    k_positions=None):
    """Plain version of the flash-attention kernel, as the reference's
    oracle computes it: GQA by head grouping, dot then divide by sqrt(hd),
    ``mask_value`` where a key is masked, softmax. q: (B, Sq, H, hd); k, v:
    (B, Sk, KV, hd) -> (B, Sq, H, hd). Positions default to the row indices
    (query i at i, key j at j). A query row that sees no key at all gets
    the softmax's uniform average here and exact zeros from the kernel;
    no caller of the port builds such a row. In bf16, as the Pallas
    kernel: q, k and v upcast, scores and p in fp32, the output rounded
    once to q's dtype (``repro.kernels.ref`` rounds p to v's dtype); in
    fp32 the two are the same."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev).expand(B, Sq)
    if k_positions is None:
        k_positions = torch.arange(Sk, device=dev).expand(B, Sk)
    qg = q.float().reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    diff = (q_positions.long()[:, None, None, :, None]
            - k_positions.long()[:, None, None, None, :])
    ok = torch.ones(diff.shape, dtype=torch.bool, device=dev)
    if causal:
        ok &= diff >= 0
    if window > 0:
        ok &= diff < window
    s = torch.where(ok, s, mask_value(s.dtype))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", p, v.float()).reshape(
        B, Sq, H, hd).to(q.dtype)


def flash_attention_kv(q, k, v, *, causal=True, window=0):
    """Plain version of the K/V-exporting prefill: the attention output and
    the K/V inputs themselves, the ``(O, K, V)`` contract."""
    return flash_attention(q, k, v, causal=causal, window=window), k, v


def wkv6(r, k, v, w, u, s0):
    """Plain version of the RWKV6 wkv kernel, the recurrence step by step in
    fp32. r, k, v, w: (B, T, H, N); u: (H, N); s0: (B, H, N, N). Per time
    step, ``kv = k v^T``, ``y = r . (S + u * kv)``, ``S = w * S + kv``.
    Returns (y (B, T, H, N), the final state (B, H, N, N)), both fp32. The
    models' sequential scan (``ssm`` impl 'scan') is this function."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    S = s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               S + u[None, :, :, None] * kv))
        S = w[:, t][..., None] * S + kv
    return torch.stack(ys, 1), S


def selective_scan(x, dt, b, c, a, h0):
    """Plain version of the mamba selective-scan kernel. x, dt: (B, T, D);
    b, c: (B, T, N); a: (D, N); h0: (B, D, N). Per time step,
    ``h = exp(a * dt) * h + (dt * x) b``, ``y = h . c``. Returns (y (B, T,
    D), the final state (B, D, N)). The hybrid's sequential scan
    (``hybrid`` impl 'scan') is this function."""
    h = h0
    ys = []
    for t in range(x.shape[1]):
        decay = torch.exp(a[None] * dt[:, t, :, None])
        h = decay * h + (dt[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return torch.stack(ys, 1), h
