"""Model layers of the port: norms (rmsnorm, layernorm), RoPE, the QKV
projection, full-sequence attention (einsum, chunked, banded, flash
kernel), decode and prefill-chunk attention against a dense or a paged KV
cache (fp32 or int8 pages), MLA latent attention (dense latent cache or
latent pages), the MLP (gated SiLU, or ungated GELU / SiLU with optional
biases), the grouped-capacity top-k mixture of experts, embeddings and
logits, and the freed-slot gate of the recurrent families' state. Counterpart of the same-named
functions in ``repro/models/layers.py`` (same argument layouts and
operation order); parameters are dicts of tensors.

Under a tensor-parallel serving mesh (``sharding.specs``) the paged paths
take the reference's head-shard decision: the rank writes only its
kv-head slab of each new K/V row into its slab of the pool, attends on its
own query heads and all-gathers the head outputs before ``wo``
(``specs.replicate``); everything else runs replicated.

Inside the sharded steps (``sharding.spmd``) the dense, MoE and
recurrent decoders' attention, MLP, experts and embedding run on the
rank's "model" blocks of their weights (heads, d_ff, experts, vocab).
With more than one row the residual keeps the rank's rows of the
sequence: the rows are gathered before a split product and its sums
reduce-scattered back, and attention whose heads do not divide "model"
runs the rank's query rows against every rank's K / V rows (a band that
``repro``'s context-parallel form covers: its own rows and a halo). A
MoE layer routes the rank's own dispatch groups where they divide the
batch's ranks, else the whole batch's tokens (:func:`moe`). The lockstep
decode over a cache whose sequence is split over "model" runs flash
decode (each rank's partial softmax, merged); a windowed attention runs
the banded form over each rank's chunks with a halo from its
neighbour.

Where ``repro`` returns a functionally updated cache or page pool
(``dynamic_update_slice``, ``.at[].set(mode="drop")``), the port writes it
IN PLACE and returns the same tensor. Rows that JAX would drop (freed
slots, unallocated pages, rows below a prefix write floor) are removed by
masking first, because ``index_put_`` does not drop out-of-range indices,
and a slice start is clamped as ``dynamic_update_slice`` clamps it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import page_scale
from repro_torch.kernels.ref import mask_value
from repro_torch.sharding import specs as _sp
from repro_torch.sharding import spmd


def rmsnorm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm in fp32 with the population variance, as ``jnp.var``
    computes it (``torch.var`` would default to the unbiased one)."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    xc = x - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    out = xc * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dtype)


# ---------------------------------------------------------------- activations
# ``jax.nn``'s activations as XLA evaluates them: the expression in the
# input's dtype, every op rounding to it (constants rounded first). In bf16
# that is what ``repro`` computes, bit for bit, where torch's fused
# ``F.silu`` / ``torch.sigmoid`` / ``F.gelu`` compute in fp32 and round
# once (they differ from it in 30-40 % of bf16 elements). In fp32 the
# fused ops are kept: they are within an ulp of XLA's, and the fp32 path
# keeps its bits.
def sigmoid(x):
    """``jax.nn.sigmoid``: 1 / (1 + exp(-x))."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: x * sigmoid(x)."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * sigmoid(x)


def gelu(x):
    """``jax.nn.gelu`` (tanh approximation): x * 0.5 * (1 + tanh(sqrt(2 /
    pi) * (x + 0.044715 x^3)))."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=torch.float64).to(x.dtype)
    a = torch.tensor(0.044715, dtype=torch.float64).to(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x)))))


def apply_norm(x, params, kind: str):
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params["bias"])


def norm_init(d: int, lead=(), device=None, kind: str = "rmsnorm"):
    """rmsnorm: the scale, stored as the offset from 1 (zeros = identity);
    layernorm: a scale of ones and a bias of zeros."""
    shape = tuple(lead) + (d,)
    if kind == "rmsnorm":
        return {"scale": torch.zeros(shape, device=device)}
    return {"scale": torch.ones(shape, device=device),
            "bias": torch.zeros(shape, device=device)}



def norm_logical(kind: str):
    """Logical axes of ``norm_init``'s leaves (``sharding.specs``)."""
    if kind == "rmsnorm":
        return {"scale": (None,)}
    return {"scale": (None,), "bias": (None,)}

def remat(fn, policy):
    """``fn`` checkpointed for training, as ``repro`` wraps a layer's body
    in ``jax.checkpoint``: only its inputs are saved and the body runs
    again in the backward (``torch.utils.checkpoint``, not reentrant).
    ``policy`` is ``repro``'s ``remat``: False keeps ``fn``; True and
    "save_outs" both checkpoint (the reference's "save_outs" also saves the
    attention and MLP outputs, which changes memory, not the numbers)."""
    if not policy:
        return fn
    from torch.utils.checkpoint import checkpoint

    def run(*args):
        return checkpoint(spmd.checkpointed(fn), *args, use_reentrant=False)
    return run


def layer_params(tree, i: int):
    """Layer ``i``'s parameters from a tree whose leaves are stacked along a
    leading L axis (views, not copies; inside the sharded train step the
    rank's blocks, read per layer: ``sharding.spmd.LazyParams``)."""
    if isinstance(tree, spmd.LazyParams):
        return tree.layer(i)
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}



def stacked_logical(tree):
    """A layer's logical tree for its stack: None prepended to every leaf
    for the leading L axis."""
    return {k: stacked_logical(v) if isinstance(v, dict) else (None,) + v
            for k, v in tree.items()}

# ---------------------------------------------------------------- RoPE
@functools.lru_cache(maxsize=None)
def rope_freqs(head_dim: int, theta: float, device=None):
    """1 / theta^(2i / head_dim), the power taken in float64 and rounded to
    float32: what ``repro``'s layers get from XLA's compiled float32 power
    (they run compiled), where torch's float32 ``pow`` can differ by one
    ulp. That ulp is invisible at real positions, but an inactive slot
    sits at INACTIVE_POS = 2^30, where it moves the angle by whole radians,
    and an MoE layer still routes that slot's row. Computed once per
    (head_dim, theta, device), on the CPU, and moved; callers only read
    it. It is a real tensor even when first asked for under a dispatch
    mode (the dry run's fake tensors and counters), so the cache holds no
    fake tensor and counts nothing."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        e = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
        return (1.0 / theta ** e.double()).float().to(device)


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



def attn_logical(dims: AttnDims):
    p = {"wq": ("fsdp", "heads"), "wk": ("fsdp", "kv_heads"),
         "wv": ("fsdp", "kv_heads"), "wo": ("heads", "fsdp")}
    if dims.qkv_bias:
        p.update({"bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",)})
    return p

def mlp_init(gen, d_model: int, d_ff: int, lead=(), device=None,
             gated: bool = True, bias: bool = False):
    """MLP weights with leading axes ``lead``: a gate projection when
    ``gated``, zero biases ``b_up`` / ``b_down`` when ``bias``."""
    lead = tuple(lead)
    p = {"w_up": _dense(gen, lead + (d_model, d_ff), d_model, device),
         "w_down": _dense(gen, lead + (d_ff, d_model), d_ff, device)}
    if gated:
        p["w_gate"] = _dense(gen, lead + (d_model, d_ff), d_model, device)
    if bias:
        p["b_up"] = torch.zeros(lead + (d_ff,), device=device)
        p["b_down"] = torch.zeros(lead + (d_model,), device=device)
    return p



def mlp_logical(gated: bool = True, bias: bool = False):
    p = {"w_up": ("fsdp", "d_ff"), "w_down": ("d_ff", "fsdp")}
    if gated:
        p["w_gate"] = ("fsdp", "d_ff")
    if bias:
        p["b_up"] = ("d_ff",)
        p["b_down"] = (None,)
    return p

def embed_init(gen, padded_vocab: int, d_model: int, device=None):
    return {"table": torch.randn((padded_vocab, d_model), generator=gen,
                                 device=device) * 0.02}



def embed_logical():
    return {"table": ("vocab", "fsdp")}

# ---------------------------------------------------------------- attention
def _proj(params, x, name: str, heads: int, dims: AttnDims, positions):
    """One of the q / k / v projections, (B, S, heads, hd), RoPE'd for q
    and k."""
    B, S, _ = x.shape
    y = x @ params["w" + name].to(x.dtype)
    if dims.qkv_bias:
        y = y + params["b" + name].to(x.dtype)
    y = y.reshape(B, S, heads, dims.head_dim)
    if dims.rope_theta > 0 and name != "v":
        y = apply_rope(y, positions, dims.rope_theta)
    return y


def _qkv(params, x, dims: AttnDims, positions):
    return tuple(_proj(params, x, n, h, dims, positions) for n, h in
                 (("q", dims.num_heads), ("k", dims.num_kv_heads),
                  ("v", dims.num_kv_heads)))


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


def _chunk_fn(q):
    """``_sdpa_einsum`` for one chunk: checkpointed where autograd records
    it, as ``repro`` checkpoints each chunk, so the backward keeps only a
    chunk's inputs and computes its scores again."""
    return remat(_sdpa_einsum, torch.is_grad_enabled() and q.requires_grad)


def _sdpa_chunked(q, k, v, q_pos, k_pos, dims: AttnDims, q_chunk: int = 1024):
    """``_sdpa_einsum`` over query chunks of about ``q_chunk`` rows, which
    bounds live memory to O(q_chunk * Sk)."""
    B, Sq, H, hd = q.shape
    n_chunks = max(1, Sq // q_chunk)
    q_chunk = Sq // n_chunks
    qs = q.reshape(B, n_chunks, q_chunk, H, hd)
    qp = q_pos.reshape(B, n_chunks, q_chunk)
    fn = _chunk_fn(q)
    return torch.cat([fn(qs[:, c], k, v, qp[:, c], k_pos, dims)
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
    fn = _chunk_fn(q)
    outs = []
    for ci in range(n_chunks):
        qs = ci * q_chunk
        ks = max(0, qs - W)
        ke = qs + q_chunk
        q_pos = torch.arange(qs, qs + q_chunk, device=dev).expand(B, q_chunk)
        k_pos = torch.arange(ks, ke, device=dev).expand(B, ke - ks)
        outs.append(fn(q[:, qs:qs + q_chunk], k[:, ks:ke], v[:, ks:ke],
                       q_pos, k_pos, dims))
    return torch.cat(outs, dim=1)


def _sdpa_banded_cp(q, k, v, dims: AttnDims, q_chunk: int = 1024):
    """``repro``'s context-parallel banded form on a replicated q, k, v
    (B, S, ., hd): each "model" rank attends its own whole query chunks
    (``spmd.sp_own``) against its own K/V rows and the previous rank's
    last ``window`` rows (``spmd.halo``), and the output rows are gathered
    back (``spmd.sp_replicate``). Where ``repro`` falls back (no "model"
    axis above 1, chunks not dividing it, fewer rows than window + chunk,
    a halo wider than a rank's rows) it is ``_sdpa_banded``."""
    S = q.shape[1]
    C = _band_chunk(S, dims.window, q_chunk)
    if not C:
        return _sdpa_banded(q, k, v, dims, q_chunk)
    out = _banded_rows(spmd.sp_own(q), spmd.sp_own(k), spmd.sp_own(v), dims,
                       C, S)
    return spmd.sp_replicate(out)


def _band_chunk(S: int, W: int, q_chunk: int = 1024) -> int:
    """The chunk rows C of ``repro``'s context-parallel banded form over a
    sequence of S rows split over "model", or 0 where it falls back: no
    "model" axis above 1, chunks not dividing it, fewer rows than W + C,
    or a halo of W rows wider than a rank's."""
    n_seq = spmd.model_ways()
    n_chunks = max(1, S // q_chunk)
    C = S // n_chunks
    if (n_seq <= 1 or n_chunks % n_seq or S < W + C or S != n_chunks * C
            or W > C * (n_chunks // n_seq)):
        return 0
    return C


def _banded_rows(q, k, v, dims: AttnDims, C: int, S: int):
    """The banded form on a rank's rows (B, S / M, ., hd), whole chunks of
    C rows: chunk i attends the band of its rows and the W before them,
    read from [halo, own rows]; a halo row before position 0 (rank 0's
    zeros) sits at the sentinel S + W + 1, which the causal mask drops."""
    B, n = q.shape[:2]
    W = dims.window
    ci0 = spmd.model_rank() * (n // C)
    k_ext = torch.cat([spmd.halo(k, W), k], dim=1)   # rows [lo - W, hi)
    v_ext = torch.cat([spmd.halo(v, W), v], dim=1)
    dev = q.device
    fn = _chunk_fn(q)
    outs = []
    for i in range(n // C):
        ci = ci0 + i
        q_pos = (ci * C + torch.arange(C, device=dev)).expand(B, C)
        raw = (ci0 * C - W) + i * C + torch.arange(W + C, device=dev)
        k_pos = torch.where(raw >= 0, raw, S + W + 1).expand(B, W + C)
        outs.append(fn(q[:, i * C:(i + 1) * C],
                       k_ext[:, i * C:i * C + W + C],
                       v_ext[:, i * C:i * C + W + C], q_pos, k_pos, dims))
    return torch.cat(outs, dim=1)


def attention(params, x, dims: AttnDims, positions, impl: str = "einsum",
              kv_override=None):
    """Full-sequence self-attention, or cross-attention when
    ``kv_override=(k, v, k_pos)`` gives the keys, values and key
    positions. ``impl``: 'einsum' (the reference), 'chunked' (query
    chunks; the band only for causal windowed self-attention), 'banded' or
    'pallas' (the flash-attention kernel, ``kernels.ops``). The band runs
    as ``repro``'s context-parallel form (:func:`_sdpa_banded_cp`), which
    is the mesh-free banded one outside a "model" axis above 1.

    Inside the sharded step with the residual's rows over "model"
    (``spmd.sp_on``; x and ``positions`` the rank's rows): with the heads
    over "model" the rows are gathered before the rank's column-parallel
    projections and ``wo``'s partial products reduce-scattered back onto
    the rank's rows (sequence parallelism); otherwise the rank's query
    rows attend every rank's K / V rows, gathered along the sequence
    (context parallelism; a band that ``repro``'s context-parallel form
    covers reads only the rank's K / V rows and the previous rank's last
    ``window``, :func:`_banded_rows`), and ``wo`` needs no collective.
    Cross-attention gathers the rows and keeps the rank's after. Without
    ``sp`` the heads over "model" take the replicated x and sum after
    ``wo``."""
    self_kv = kv_override is None
    params, x, dims, tp = _read_heads(params, x, dims, self_kv)
    sp = spmd.sp_on()
    cp = sp and self_kv and not tp
    band = impl == "banded" or (impl == "chunked" and dims.window > 0
                                and dims.causal and self_kv)
    # the context-parallel band: the rank's rows and a halo, no gather
    own_band = cp and band and _band_chunk(x.shape[1] * spmd.model_ways(),
                                           dims.window)
    if sp and not cp:
        x, positions = spmd.sp_gather(x), spmd.full_positions(positions)
    elif tp:
        x = spmd.tp_copy(x)
    if self_kv:
        q, k, v = _qkv(params, x, dims, positions)
        k_pos = positions
        if cp and not own_band:
            k, v = spmd.sp_gather(k), spmd.sp_gather(v)
            k_pos = spmd.full_positions(positions)
    else:       # cross-attention: x gives the queries only
        q = _proj(params, x, "q", dims.num_heads, dims, positions)
        k, v, k_pos = kv_override
    if own_band:
        out = _banded_rows(q, k, v, dims, own_band, q.shape[1]
                           * spmd.model_ways())
    elif band and not (cp or tp):
        out = _sdpa_banded_cp(q, k, v, dims)
    elif band and tp:           # the rank's heads: no halo across them
        out = _sdpa_banded(q, k, v, dims)
    elif impl in ("chunked", "banded"):
        out = _sdpa_chunked(q, k, v, positions, k_pos, dims)
    elif impl == "pallas":
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, k, v, causal=dims.causal,
                                   window=dims.window, q_positions=positions,
                                   k_positions=k_pos)
    else:
        out = _sdpa_einsum(q, k, v, positions, k_pos, dims)
    B, S, H, hd = out.shape
    out = out.reshape(B, S, H * hd) @ params["wo"].to(x.dtype)
    if sp and not cp:
        return spmd.sp_scatter(out) if tp else spmd.sp_narrow(out)
    return spmd.tp_sum(out) if tp else out


def _read_heads(params, x, dims: AttnDims, self_kv: bool = True):
    """(the weights an attention call reads, each read once, x, dims, tp?).
    Inside the sharded step a read gathers the weight, so each is read
    once, and the key / value weights only where x gives the keys
    (``self_kv``). With the heads over "model" (the sharded dense decoder)
    ``dims`` counts the rank's heads; the caller moves x into them."""
    names = ("wq", "bq", "wo") + (("wk", "wv", "bk", "bv") if self_kv
                                   else ())
    params = {k: params[k] for k in names if k in params}
    tp = spmd.tp_split(params["wq"]) is not None
    if tp:
        dims = dataclasses.replace(
            dims, num_heads=params["wq"].shape[-1] // dims.head_dim,
            num_kv_heads=(params["wk"].shape[-1] // dims.head_dim
                          if self_kv else dims.num_kv_heads))
    return params, x, dims, tp


# Sentinel cache position of an INACTIVE (freed / never-admitted) serving
# slot: >= any reachable position, so every cache write from such a slot is
# dropped and freed rows stay bit-stable.
INACTIVE_POS = 1 << 30


def freeze_inactive_rows(pos, new, old):
    """Per-slot recurrent-state update gate of serving decode: rows of
    INACTIVE slots (a vector ``pos`` at the sentinel) keep their ``old``
    value bit for bit; a scalar (lockstep) pos changes nothing. ``new`` and
    ``old`` are dicts of tensors that lead with the batch axis."""
    if pos.dim() != 1:
        return new
    act = pos < INACTIVE_POS
    return {key: torch.where(act.reshape((-1,) + (1,) * (n.dim() - 1)), n,
                             old[key])
            for key, n in new.items()}


def resolve_scan_impl(impl: str, x, cpu_impl: str) -> str:
    """A recurrent family's scan route: 'auto' is the kernel ('pallas') on
    a CUDA tensor and ``repro``'s own choice ``cpu_impl`` on the CPU; any
    other name passes through."""
    if impl == "auto":
        return "pallas" if x.is_cuda else cpu_impl
    return impl


def decode_positions(pos, batch: int):
    """(B, 1) query positions from a cache ``pos`` that is a scalar
    (lockstep batch) or a (B,) per-slot vector."""
    if pos.dim() == 1:
        return pos[:, None]
    return torch.full((batch, 1), int(pos), dtype=torch.int64,
                      device=pos.device)


def _decode_sdpa_local(q, ck, cv, cache_pos, k_positions, window, hd):
    """Partial-softmax decode attention over a cache slice: q
    (B,1,KV,G,hd); ck/cv (B,S,KV,hd); k_positions (B,S) or (1,S) global;
    cache_pos (B,1) or a scalar. Returns (m (B,KV,G,1), l (B,KV,G,1), acc
    (B,KV,G,1,hd)), the statistics a flash-decode merge combines
    (``spmd.cp_merge``)."""
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
    return m, l, acc


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
    the window) are attended. Returns (out, cache_k, cache_v). In the
    sharded serving step with heads over "model" the cache holds this
    rank's kv heads and the projections its heads; with the cache's
    sequence over "model" (``spmd.cp_cache``, a scalar position) it holds
    the rank's rows, and the attention runs as flash decode
    (:func:`_decode_cp`)."""
    params, x, dims, tp = _read_heads(params, x, dims)
    if tp:
        x = spmd.tp_copy(x)
    q, k, v = _qkv(params, x, dims, positions)
    B, S_max, KV, hd = cache_k.shape
    G = dims.num_heads // KV
    qg = q.reshape(B, 1, KV, G, hd)
    if cache_pos.dim() == 0 and spmd.cp_cache():
        out = _decode_cp(qg, k, v, cache_k, cache_v, int(cache_pos), dims)
    else:
        if cache_pos.dim() == 0:
            cache_pos = int(cache_pos)
            mask_pos = cache_pos
        else:
            mask_pos = cache_pos.long()[:, None]
        _write_row(cache_k, k[:, 0], cache_pos)
        _write_row(cache_v, v[:, 0], cache_pos)
        k_positions = torch.arange(S_max, device=x.device)[None, :]
        _, l, acc = _decode_sdpa_local(qg, cache_k, cache_v, mask_pos,
                                       k_positions, dims.window, hd)
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(
        B, 1, dims.num_heads * hd)
    out = out @ params["wo"].to(x.dtype)
    return (spmd.tp_sum(out) if tp else out), cache_k, cache_v


def _decode_cp(qg, k, v, cache_k, cache_v, pos: int, dims: AttnDims):
    """``repro``'s context-parallel decode: the rank holds rows [r * s_loc,
    (r + 1) * s_loc) of the cache's sequence. Only the rank that owns
    ``pos`` writes the new row (at its clipped local index), each rank's
    partial softmax runs over its own rows at their global positions, and
    ``spmd.cp_merge`` combines them. Returns (B, KV, G, 1, hd) fp32."""
    s_loc = cache_k.shape[1]
    lo = spmd.model_rank() * s_loc
    rel = pos - lo
    if 0 <= rel < s_loc:
        cache_k[:, rel] = k[:, 0].to(cache_k.dtype)
        cache_v[:, rel] = v[:, 0].to(cache_v.dtype)
    k_positions = lo + torch.arange(s_loc, device=qg.device)[None, :]
    m, l, acc = _decode_sdpa_local(qg, cache_k, cache_v, pos, k_positions,
                                   dims.window, qg.shape[-1])
    return spmd.cp_merge(m, l, acc)


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


# ------------------------------------------- int8 page writes (q8 backend)
def _requant_page(blk, content, groups: int = 1):
    """Symmetric int8 scales per page from its LIVE rows only, one per
    kv-head group (``groups`` = 1 without tensor parallelism: the whole
    page). blk: (B, ps, KV, hd) f32 dequantized page content; content:
    (B, ps) bool — rows past the sequence frontier may hold a recycled
    page's stale payload, so they are left out of the amax and zeroed.
    Returns (q (B, ps, KV, hd) int8, scale (B, groups) f32)."""
    B, ps, KV, hd = blk.shape
    masked = torch.where(content[..., None, None], blk, 0.0)
    g = masked.reshape(B, ps, groups, KV // groups, hd)
    scale = page_scale(g.abs().amax(dim=(1, 3, 4)))
    q = torch.clamp(torch.round(g / scale[:, None, :, None, None]),
                    -127, 127).to(torch.int8)
    return q.reshape(B, ps, KV, hd), scale


def _dequant_page_block(pool_pg, scale_pg):
    """Dequantize gathered int8 pages (B, ps, KV, hd) with their per-group
    scales (B, T): group t scales the contiguous KV/T kv-head slab t."""
    B, ps, KV, hd = pool_pg.shape
    T = scale_pg.shape[-1]
    g = pool_pg.float().reshape(B, ps, T, KV // T, hd)
    return (g * scale_pg[:, None, :, None, None]).reshape(B, ps, KV, hd)


def paged_append_row_q8(pool, scale, rows, block_tables, safe_pos, valid):
    """Decode-append one K/V row per slot into an INT8 page pool, IN PLACE.

    The page is the quantization block: the slot's current page is
    dequantized, the new row overlaid at ``safe_pos % ps``, rows past it
    zeroed (stale), and the page re-quantized with fresh scales. Invalid
    writes (freed slots, unallocated pages) drop both the page and its
    scale. pool: (P, ps, KV, hd) int8; scale: (P, T) f32; rows: (B, KV,
    hd); safe_pos: (B,) clipped positions; valid: (B,) bool. Returns
    (pool, scale)."""
    P, ps = pool.shape[:2]
    mps = block_tables.shape[1]
    B = rows.shape[0]
    T = scale.shape[-1]
    safe_pos = safe_pos.long()
    page = torch.gather(block_tables.long(), 1,
                        (safe_pos // ps).clamp(0, mps - 1)[:, None])[:, 0]
    pg = page.clamp(0, P - 1)
    blk = _dequant_page_block(pool[pg], scale[pg])
    off = safe_pos % ps
    blk[torch.arange(B, device=blk.device), off] = rows.float()
    content = torch.arange(ps, device=blk.device)[None, :] <= off[:, None]
    q, new_scale = _requant_page(blk, content, T)
    keep = valid & (page >= 0)
    pool[pg[keep]] = q[keep]
    scale[pg[keep]] = new_scale[keep]
    return pool, scale


def paged_splice_chunk_q8(pool, scale, rows, block_tables, positions,
                          write_floor):
    """Chunk-splice C rows per slot into an INT8 page pool, IN PLACE (the
    incremental prefill splice, quantized). Each logical page the chunk
    overlaps (at most C // ps + 2) is dequantized, overlaid with the
    chunk's rows and re-quantized whole, so a copy-on-write partial page
    gets its fresh scales here, once. Pages the chunk does not write
    (aliased prefix pages below ``write_floor``) keep payload and scales.

    pool: (P, ps, KV, hd) int8; scale: (P, T) f32; rows: (B, C, KV, hd);
    positions: (B, C) absolute positions (contiguous, shared start);
    write_floor: the first writable logical row. Returns (pool, scale)."""
    P, ps = pool.shape[:2]
    B, C = positions.shape
    mps = block_tables.shape[1]
    n_rows = mps * ps
    T = scale.shape[-1]
    dev = pool.device
    positions = positions.long()
    start = positions[:, :1]                          # (B, 1)
    b_idx = torch.arange(B, device=dev)[:, None]
    for t in range((C - 1) // ps + 2):
        lpg = positions[:, 0] // ps + t               # (B,) logical page
        page = torch.gather(block_tables.long(), 1,
                            lpg.clamp(0, mps - 1)[:, None])[:, 0]
        in_range = (lpg < mps) & (page >= 0)
        pg = page.clamp(0, P - 1)
        blk = _dequant_page_block(pool[pg], scale[pg])
        row_pos = lpg[:, None] * ps + torch.arange(ps, device=dev)[None, :]
        ci = row_pos - start                          # chunk-relative index
        from_chunk = ((ci >= 0) & (ci < C) & (row_pos >= write_floor)
                      & (row_pos < n_rows))
        chunk_rows = rows[b_idx, ci.clamp(0, C - 1)]  # (B, ps, KV, hd)
        blk = torch.where(from_chunk[..., None, None], chunk_rows.float(), blk)
        content = (row_pos <= start + C - 1) & (row_pos < n_rows)
        q, new_scale = _requant_page(blk, content, T)
        keep = from_chunk.any(dim=1) & in_range
        pool[pg[keep]] = q[keep]
        scale[pg[keep]] = new_scale[keep]
    return pool, scale


def dequant_paged_view(view, phys, scale, page_size: int, dtype):
    """Dequantize a block-table-gathered int8 view (B, n_rows, KV, hd) with
    the (P,) or (P, T) scales of the pages each row came from."""
    P = scale.shape[0]
    pg = (phys // page_size).clamp(0, P - 1)
    sc = scale[pg]                       # (B, n_rows) or (B, n_rows, T)
    if sc.dim() == 2:
        sc = sc[..., None]
    B, n, KV, hd = view.shape
    T = sc.shape[-1]
    g = view.float().reshape(B, n, T, KV // T, hd)
    return (g * sc[..., None, None]).reshape(view.shape).to(dtype)


def attention_decode_paged(params, x, dims: AttnDims, pool_k, pool_v,
                           block_tables, cache_pos, positions,
                           impl: str = "einsum", *, k_scale=None,
                           v_scale=None):
    """Single-token decode against a PAGED KV cache.

    x: (B,1,D); pool_k/pool_v: (P, page_size, KV, hd), one layer's slice of
    the shared pool; block_tables: (B, mps) int32, -1 = unallocated;
    cache_pos: (B,) per-slot positions. The new K/V row is written in place
    at page block_tables[b, pos // ps], offset pos % ps; writes from slots
    whose position is out of range (freed slots at INACTIVE_POS) or whose
    page is unallocated are dropped. ``impl='kernel'`` reads through the
    paged-attention kernel (``kernels.ops.paged_decode``); ``'einsum'`` is
    the masked-gather reference over the full block-table span. Returns
    (out, pool_k, pool_v).

    ``k_scale``/``v_scale``: the int8 backend's (P, 1) per-page scales of
    this layer. The new row's write re-quantizes the slot's current page
    in place (``paged_append_row_q8``), reads dequantize per page (inside
    the kernel's gather on the kernel path), and the return grows to
    (out, pool_k, pool_v, k_scale, v_scale).

    Under a tensor-parallel mesh whose axis divides the head counts
    (``specs.head_shard_axis``) the pools (and scales) are this rank's
    kv-head slab: the rank writes its slab of the new row, attends on its
    query heads and all-gathers the output before ``wo``."""
    q, k, v = _qkv(params, x, dims, positions)
    P, ps, KV, hd = pool_k.shape          # KV: the kv heads this rank holds
    B = q.shape[0]
    mps = block_tables.shape[1]
    n_rows = mps * ps
    H = dims.num_heads
    G = H // dims.num_kv_heads
    quantized = k_scale is not None
    tp_mesh, tp_axis = _sp.head_shard_axis(H, dims.num_kv_heads)
    if tp_mesh is not None:
        kv_slab = _sp.head_slab(dims.num_kv_heads, tp_mesh, tp_axis)
        k, v = k[:, :, kv_slab], v[:, :, kv_slab]

    pos = cache_pos.long()
    safe_pos = pos.clamp(0, n_rows - 1)
    w_row, page_ok = paged_write_target(block_tables, safe_pos, ps)
    w_ok = (pos >= 0) & (pos < n_rows) & page_ok
    if quantized:
        paged_append_row_q8(pool_k, k_scale, k[:, 0], block_tables, safe_pos,
                            w_ok)
        paged_append_row_q8(pool_v, v_scale, v[:, 0], block_tables, safe_pos,
                            w_ok)
    else:
        paged_write_rows(pool_k, k[:, 0], w_row, w_ok)
        paged_write_rows(pool_v, v[:, 0], w_row, w_ok)

    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        bt, cp = block_tables.int().contiguous(), cache_pos.int().contiguous()
        sharding = dict(mesh=tp_mesh, shard_axis=tp_axis)
        if quantized:
            out = kops.paged_decode_q8(q, pool_k, pool_v, k_scale, v_scale,
                                       bt, cp, window=dims.window, **sharding)
        else:
            out = kops.paged_decode(q, pool_k, pool_v, bt, cp,
                                    window=dims.window, **sharding)
        out = out.reshape(B, 1, KV * G * hd)
    else:
        if tp_mesh is not None:
            q = q[:, :, _sp.head_slab(H, tp_mesh, tp_axis)]
        qg = q.reshape(B, 1, KV, G, hd)
        phys, ok = paged_row_indices(block_tables, ps, n_rows)
        view_k = pool_k.reshape(P * ps, KV, hd)[phys]   # (B, n_rows, KV, hd)
        view_v = pool_v.reshape(P * ps, KV, hd)[phys]
        if quantized:
            view_k = dequant_paged_view(view_k, phys, k_scale, ps, q.dtype)
            view_v = dequant_paged_view(view_v, phys, v_scale, ps, q.dtype)
        k_positions = torch.where(
            ok, torch.arange(n_rows, device=x.device)[None, :], INACTIVE_POS)
        _, l, acc = _decode_sdpa_local(qg, view_k, view_v, pos[:, None],
                                       k_positions, dims.window, hd)
        out = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
        out = out.permute(0, 3, 1, 2, 4).reshape(B, 1, KV * G * hd)
    if tp_mesh is not None:
        # the one all-gather of the layer, BEFORE wo: an un-split wo
        # contraction keeps tp > 1 bitwise equal to tp = 1
        out = _sp.replicate(out)
    out = out @ params["wo"].to(x.dtype)
    if quantized:
        return out, pool_k, pool_v, k_scale, v_scale
    return out, pool_k, pool_v


def attention_prefill_chunk_paged(params, x, dims: AttnDims, pool_k, pool_v,
                                  block_tables, positions, write_floor: int,
                                  impl: str = "kernel", *, k_scale=None,
                                  v_scale=None):
    """Prefill-chunk attention directly against the paged pool.

    x: (B, C, D); pool_k/pool_v: one layer's (P, ps, KV, hd) pool slice;
    block_tables: (B, mps); positions: (B, C) absolute query positions
    (contiguous, sharing a start); write_floor: the first logical row this
    group may write. The chunk's post-RoPE K/V rows are written in place
    into the slots' pages; rows below ``write_floor`` (shared immutable
    prefix pages) are dropped. Attention then reads prior chunks, aliased
    prefix pages and the chunk itself through the block table
    (``impl='kernel'``: ``ops.paged_prefill``; ``'einsum'``: masked gather).
    Returns (out (B, C, D), pool_k, pool_v).

    ``k_scale``/``v_scale``: the int8 backend's (P, 1) per-page scales of
    this layer. The splice re-quantizes each page the chunk writes
    (``paged_splice_chunk_q8``; aliased prefix pages keep their shared
    scales), reads dequantize per page, and the return grows to (out,
    pool_k, pool_v, k_scale, v_scale). Under a tensor-parallel mesh the
    rank splices its kv-head slab and attends on its query heads, as in
    ``attention_decode_paged``."""
    q, k, v = _qkv(params, x, dims, positions)
    B, C = k.shape[:2]
    P, ps, KV, hd = pool_k.shape          # KV: the kv heads this rank holds
    mps = block_tables.shape[1]
    n_rows = mps * ps
    H = dims.num_heads
    G = H // dims.num_kv_heads
    quantized = k_scale is not None
    tp_mesh, tp_axis = _sp.head_shard_axis(H, dims.num_kv_heads)
    if tp_mesh is not None:
        kv_slab = _sp.head_slab(dims.num_kv_heads, tp_mesh, tp_axis)
        k, v = k[:, :, kv_slab], v[:, :, kv_slab]

    pos = positions.long()
    flat_k = pool_k.view(P * ps, KV, hd)
    flat_v = pool_v.view(P * ps, KV, hd)
    if quantized:
        paged_splice_chunk_q8(pool_k, k_scale, k, block_tables, positions,
                              write_floor)
        paged_splice_chunk_q8(pool_v, v_scale, v, block_tables, positions,
                              write_floor)
    else:
        page = torch.gather(block_tables.long(), 1,
                            (pos // ps).clamp(0, mps - 1))
        w_ok = ((page >= 0) & (pos >= write_floor) & (pos >= 0)
                & (pos < n_rows))
        w_rows = (page * ps + pos % ps)[w_ok]
        flat_k[w_rows] = k[w_ok].to(flat_k.dtype)
        flat_v[w_rows] = v[w_ok].to(flat_v.dtype)

    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        bt = block_tables.int().contiguous()
        st = positions[:, 0].int().contiguous()
        sharding = dict(mesh=tp_mesh, shard_axis=tp_axis)
        if quantized:
            out = kops.paged_prefill_q8(q, pool_k, pool_v, k_scale, v_scale,
                                        bt, st, window=dims.window, **sharding)
        else:
            out = kops.paged_prefill(q, pool_k, pool_v, bt, st,
                                     window=dims.window, **sharding)
        out = out.reshape(B, C, KV * G * hd)
    else:
        if tp_mesh is not None:
            q = q[:, :, _sp.head_slab(H, tp_mesh, tp_axis)]
        qg = q.reshape(B, C, KV, G, hd)
        phys, ok = paged_row_indices(block_tables, ps, n_rows)
        view_k = flat_k[phys]                          # (B, n_rows, KV, hd)
        view_v = flat_v[phys]
        if quantized:
            view_k = dequant_paged_view(view_k, phys, k_scale, ps, q.dtype)
            view_v = dequant_paged_view(view_v, phys, v_scale, ps, q.dtype)
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
                           ).reshape(B, C, KV * G * hd)
    if tp_mesh is not None:
        out = _sp.replicate(out)        # all-gather before wo (see decode)
    out = out @ params["wo"].to(x.dtype)
    if quantized:
        return out, pool_k, pool_v, k_scale, v_scale
    return out, pool_k, pool_v


# ------------------------------------------------- MLA (latent attention)
# Multi-head latent attention. The cache stores, per token, ONE row of
# kv_lora_rank + qk_rope_head_dim floats: the rms-normed compressed KV
# latent and a decoupled RoPE key head shared by every query head. Every
# path runs the ABSORB form: wkv_b's key half folds into the queries and
# its value half into the output projection, so attention contracts over
# the latent rows and per-head K/V never exist. All variants share one
# operation order, which is what keeps the dense latent cache and the
# one-page latent pages bit-exact.
@dataclasses.dataclass(frozen=True)
class MLADims:
    d_model: int
    num_heads: int
    kv_lora_rank: int        # c: compressed KV latent width
    qk_rope_head_dim: int    # r: decoupled RoPE key head width
    head_dim: int            # qk_nope width == value head width
    rope_theta: float = 10000.0

    @property
    def latent_dim(self) -> int:
        """Cached floats per token: c + r (one latent page row)."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def scale_dim(self) -> int:
        """Softmax scale denominator: the per-head query width (qk_nope +
        rope), not the latent width the absorbed dot runs over."""
        return self.head_dim + self.qk_rope_head_dim


def mla_init(gen, dims: MLADims, lead=(), device=None):
    """MLA weights with leading axes ``lead`` (the layer stack)."""
    D, H = dims.d_model, dims.num_heads
    c, r, hd = dims.kv_lora_rank, dims.qk_rope_head_dim, dims.head_dim
    lead = tuple(lead)
    return {"wq": _dense(gen, lead + (D, H * (hd + r)), D, device),
            "wkv_a": _dense(gen, lead + (D, c + r), D, device),
            "kv_norm": torch.zeros(lead + (c,), device=device),
            "wkv_b": _dense(gen, lead + (c, H * 2 * hd), c, device),
            "wo": _dense(gen, lead + (H * hd, D), H * hd, device)}



def mla_logical(dims: MLADims):
    return {"wq": ("fsdp", "heads"), "wkv_a": ("fsdp", None),
            "kv_norm": (None,), "wkv_b": (None, "heads"),
            "wo": ("heads", "fsdp")}

def _mla_wkv_b(params, dims: MLADims, dtype):
    """wkv_b split into its absorbable halves: (wb_k (H, hd, c), which folds
    q_nope into latent space; wb_v (H, c, hd), which expands the latent
    attention output to value heads)."""
    c, H, hd = dims.kv_lora_rank, dims.num_heads, dims.head_dim
    wb = params["wkv_b"].to(dtype).reshape(c, H, 2 * hd)
    wb_k = wb[:, :, :hd].permute(1, 2, 0)        # (H, hd, c)
    wb_v = wb[:, :, hd:].permute(1, 0, 2)        # (H, c, hd)
    return wb_k, wb_v


def mla_absorbed_queries(params, x, dims: MLADims, positions):
    """ABSORBED queries (B, S, H, c + r): the nope half pushed through wb_k
    into latent space, the rope half rotated; they dot the cached latent
    rows directly."""
    B, S, _ = x.shape
    H, hd, r = dims.num_heads, dims.head_dim, dims.qk_rope_head_dim
    q = (x @ params["wq"].to(x.dtype)).reshape(B, S, H, hd + r)
    q_nope, q_pe = q[..., :hd], q[..., hd:]
    q_pe = apply_rope(q_pe, positions, dims.rope_theta)
    wb_k, _ = _mla_wkv_b(params, dims, x.dtype)
    q_abs = torch.einsum("bshd,hdc->bshc", q_nope, wb_k)
    return torch.cat([q_abs, q_pe], dim=-1)


def mla_latent_rows(params, x, dims: MLADims, positions):
    """Per-token latent cache rows (B, S, 1, c + r): the rms-normed
    compressed latent and the RoPE'd decoupled key head (one shared 'kv
    head')."""
    c = dims.kv_lora_rank
    kv = x @ params["wkv_a"].to(x.dtype)          # (B, S, c + r)
    ckv = rmsnorm(kv[..., :c], params["kv_norm"])
    k_pe = apply_rope(kv[..., None, c:], positions, dims.rope_theta)
    return torch.cat([ckv[:, :, None, :], k_pe], dim=-1)


def _mla_out(params, attn, dims: MLADims, x):
    """Absorbed output projection: latent attention output (B, S, H, c) ->
    value heads through wb_v -> wo. Under tensor parallelism the caller
    hands it every head: the paged latent kernel path all-gathers its head
    slabs first (``_gather_latent_heads``), so wb_v and ``wo`` contract as
    at tp = 1."""
    B, S, H, _ = attn.shape
    _, wb_v = _mla_wkv_b(params, dims, x.dtype)
    out = torch.einsum("bshc,hcd->bshd", attn, wb_v)
    return out.reshape(B, S, H * dims.head_dim) @ params["wo"].to(x.dtype)


def _gather_latent_heads(attn, tp_mesh):
    """The rank's (B, S, H / tp, c) slab of the latent attention output
    all-gathered on its head axis (identity without a head-sharded core).
    The gather comes before wb_v rather than after it, as the reference
    has it: wb_v then runs on every head at once, as at tp = 1, whatever
    a batched product of fewer heads would choose, and ``wo`` follows.
    The masked-einsum path runs every head on every rank (the latent pool
    is whole there) and gathers nothing."""
    return attn if tp_mesh is None else _sp.replicate(attn, dim=2)


def mla_attention_decode(params, x, dims: MLADims, cache_c, cache_pos,
                         positions):
    """Single-token MLA decode against a DENSE latent cache, written IN
    PLACE. x: (B, 1, D); cache_c: (B, S_max, 1, c + r); ``cache_pos`` a
    (B,) vector or a scalar, as in ``attention_decode``. Scores and values
    read the same latent rows (values: the leading c columns). Returns
    (out, cache_c)."""
    B = x.shape[0]
    H, c = dims.num_heads, dims.kv_lora_rank
    q = mla_absorbed_queries(params, x, dims, positions)     # (B,1,H,c+r)
    rows = mla_latent_rows(params, x, dims, positions)       # (B,1,1,c+r)
    if cache_pos.dim() == 0:
        cache_pos = int(cache_pos)
        mask_pos = cache_pos
    else:
        mask_pos = cache_pos.long()[:, None]
    _write_row(cache_c, rows[:, 0], cache_pos)
    qg = q.reshape(B, 1, 1, H, dims.latent_dim)              # KV=1, G=H
    k_positions = torch.arange(cache_c.shape[1], device=x.device)[None, :]
    _, l, acc = _decode_sdpa_local(qg, cache_c, cache_c[..., :c], mask_pos,
                                   k_positions, 0, dims.scale_dim)
    out = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
    attn = out.permute(0, 3, 1, 2, 4).reshape(B, 1, H, c)
    return _mla_out(params, attn, dims, x), cache_c


def mla_attention_prefill_chunk(params, x, dims: MLADims, cache_c, start,
                                positions):
    """Multi-token MLA prefill chunk against a dense latent cache, written
    IN PLACE (rows [start, start + C), the start clamped as
    ``dynamic_update_slice`` clamps it). Returns (out (B, C, D),
    cache_c)."""
    c = dims.kv_lora_rank
    q = mla_absorbed_queries(params, x, dims, positions)     # (B,C,H,c+r)
    rows = mla_latent_rows(params, x, dims, positions)       # (B,C,1,c+r)
    B, C, H, _ = q.shape
    S_max = cache_c.shape[1]
    s = min(max(int(start), 0), S_max - C)
    cache_c[:, s:s + C] = rows.to(cache_c.dtype)
    qg = q.reshape(B, C, 1, H, dims.latent_dim)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, cache_c.to(q.dtype)
                          ).float() / math.sqrt(dims.scale_dim)
    k_pos = torch.arange(S_max, device=x.device)
    valid = k_pos[None, None, :] <= positions[:, :, None]    # (B,C,S)
    scores = torch.where(valid[:, None, None, :, :], scores,
                         mask_value(scores.dtype))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    attn = torch.einsum("bkgqs,bskh->bqkgh", probs,
                        cache_c[..., :c].to(q.dtype)).reshape(B, C, H, c)
    return _mla_out(params, attn, dims, x), cache_c


def mla_attention_decode_paged(params, x, dims: MLADims, pool_c,
                               block_tables, cache_pos, positions,
                               impl: str = "einsum"):
    """Single-token MLA decode against a LATENT page pool, written IN
    PLACE. pool_c: one layer's (P, page_size, 1, c + r) slice; the write
    and the gather use the K/V path's block-table helpers. ``impl='kernel'``
    reads through the latent paged-attention kernel
    (``ops.paged_decode_latent``); 'einsum' is the masked gather, bit-exact
    with ``mla_attention_decode`` at page_size == s_max. Returns (out,
    pool_c)."""
    H, c = dims.num_heads, dims.kv_lora_rank
    q = mla_absorbed_queries(params, x, dims, positions)     # (B,1,H,c+r)
    rows = mla_latent_rows(params, x, dims, positions)       # (B,1,1,c+r)
    P, ps = pool_c.shape[:2]
    B = q.shape[0]
    n_rows = block_tables.shape[1] * ps
    pos = cache_pos.long()
    w_row, page_ok = paged_write_target(block_tables, pos.clamp(0, n_rows - 1),
                                        ps)
    w_ok = (pos >= 0) & (pos < n_rows) & page_ok
    paged_write_rows(pool_c, rows[:, 0], w_row, w_ok)

    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        tp_mesh, tp_axis = _sp.latent_head_shard_axis(H)
        attn = kops.paged_decode_latent(q, pool_c,
                                        block_tables.int().contiguous(),
                                        cache_pos.int().contiguous(),
                                        scale_dim=dims.scale_dim, d_v=c,
                                        mesh=tp_mesh, shard_axis=tp_axis)
        attn = _gather_latent_heads(attn, tp_mesh)
    else:
        qg = q.reshape(B, 1, 1, H, dims.latent_dim)
        phys, ok = paged_row_indices(block_tables, ps, n_rows)
        view = pool_c.reshape(P * ps, 1, dims.latent_dim)[phys]
        k_positions = torch.where(
            ok, torch.arange(n_rows, device=x.device)[None, :], INACTIVE_POS)
        _, l, acc = _decode_sdpa_local(qg, view, view[..., :c], pos[:, None],
                                       k_positions, 0, dims.scale_dim)
        out = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
        attn = out.permute(0, 3, 1, 2, 4).reshape(B, 1, H, c)
    return _mla_out(params, attn, dims, x), pool_c


def mla_attention_prefill_chunk_paged(params, x, dims: MLADims, pool_c,
                                      block_tables, positions,
                                      write_floor: int, impl: str = "kernel"):
    """Multi-token MLA prefill chunk splicing its latent rows straight into
    the page pool (IN PLACE; rows below ``write_floor``, in aliased prefix
    pages, are dropped) and attending through the block table: the latent
    twin of ``attention_prefill_chunk_paged``. Returns (out (B, C, D),
    pool_c)."""
    H, c = dims.num_heads, dims.kv_lora_rank
    q = mla_absorbed_queries(params, x, dims, positions)     # (B,C,H,c+r)
    rows = mla_latent_rows(params, x, dims, positions)       # (B,C,1,c+r)
    B, C = positions.shape
    P, ps = pool_c.shape[:2]
    mps = block_tables.shape[1]
    n_rows = mps * ps

    pos = positions.long()
    page = torch.gather(block_tables.long(), 1, (pos // ps).clamp(0, mps - 1))
    w_ok = ((page >= 0) & (pos >= write_floor) & (pos >= 0)
            & (pos < n_rows))
    flat = pool_c.view(P * ps, 1, dims.latent_dim)
    flat[(page * ps + pos % ps)[w_ok]] = rows[w_ok].to(flat.dtype)

    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        tp_mesh, tp_axis = _sp.latent_head_shard_axis(H)
        attn = kops.paged_prefill_latent(q, pool_c,
                                         block_tables.int().contiguous(),
                                         positions[:, 0].int().contiguous(),
                                         scale_dim=dims.scale_dim, d_v=c,
                                         mesh=tp_mesh, shard_axis=tp_axis)
        attn = _gather_latent_heads(attn, tp_mesh)
    else:
        qg = q.reshape(B, C, 1, H, dims.latent_dim)
        phys, ok = paged_row_indices(block_tables, ps, n_rows)
        view = flat[phys]                        # (B, n_rows, 1, c+r)
        scores = torch.einsum("bqkgh,bskh->bkgqs", qg, view.to(q.dtype)
                              ).float() / math.sqrt(dims.scale_dim)
        k_pos = torch.where(ok, torch.arange(n_rows, device=x.device)[None, :],
                            INACTIVE_POS)
        valid = k_pos[:, None, :] <= pos[:, :, None]          # (B,C,S)
        scores = torch.where(valid[:, None, None, :, :], scores,
                             mask_value(scores.dtype))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        attn = torch.einsum("bkgqs,bskh->bqkgh", probs,
                            view[..., :c].to(q.dtype)).reshape(B, C, H, c)
    return _mla_out(params, attn, dims, x), pool_c


# ---------------------------------------------------------------- MLP
def mlp(params, x, act: str = "silu"):
    """(silu(x @ w_gate) * up) @ w_down with a gate projection, else
    act(up) @ w_down, where up = x @ w_up; biases are added where the
    params hold them. ``act='gelu'`` is the tanh approximation, which is
    ``jax.nn.gelu``'s default (torch's default is the erf form)."""
    w_up = params["w_up"]       # read once: a read gathers it when sharded
    tp = spmd.tp_split(w_up) is not None
    sp = tp and spmd.sp_on()
    if tp:      # this rank's d_ff block of the "model" axis (every row)
        x = spmd.sp_gather(x) if sp else spmd.tp_copy(x)
    up = x @ w_up.to(x.dtype)
    if "b_up" in params:
        up = up + params["b_up"].to(x.dtype)
    if "w_gate" in params:
        h = silu(x @ params["w_gate"].to(x.dtype)) * up
    else:
        h = gelu(up) if act == "gelu" else silu(up)
    out = h @ params["w_down"].to(x.dtype)
    if tp:      # the d_ff blocks' sums, onto the rank's rows under sp
        out = spmd.sp_scatter(out) if sp else spmd.tp_sum(out)
    if "b_down" in params:
        out = out + params["b_down"].to(x.dtype)
    return out


# ---------------------------------------------------------------- MoE
@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    d_ff: int
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 128     # tokens per dispatch group (GShard)


def moe_init(gen, dims: MoEDims, lead=(), device=None):
    """Router and expert weights with leading axes ``lead``."""
    E, D, F_ = dims.num_experts, dims.d_model, dims.d_ff
    lead = tuple(lead)
    return {"router": _dense(gen, lead + (D, E), D, device),
            "w_gate": _dense(gen, lead + (E, D, F_), D, device),
            "w_up": _dense(gen, lead + (E, D, F_), D, device),
            "w_down": _dense(gen, lead + (E, F_, D), F_, device)}



def moe_logical():
    return {"router": (None, None), "w_gate": ("expert", "fsdp", None),
            "w_up": ("expert", "fsdp", None),
            "w_down": ("expert", None, "fsdp")}

# When set to a list, every ``moe`` call appends its routing: a dict of
# (T, K) ``expert`` indices, the (T, K) bool ``kept`` mask (choices that
# found room in their expert's capacity), the (T, E) router ``probs`` and
# the capacity ``cap``. Tensors are appended as they are; nothing
# synchronises the device.
MOE_TRACE: Optional[list] = None


def moe(params, x, dims: MoEDims):
    """Grouped-capacity top-k mixture of experts (GShard dispatch), as
    ``repro`` computes it. x: (B, S, D) -> ((B, S, D), {"moe_aux",
    "moe_z"}).

    Router logits in fp32, softmax, top-k, the k gates renormalised. The
    T = B * S tokens fall into G = max(1, T // group_size) groups of Sg =
    T // G (T must divide, as ``repro``'s reshape requires); each expert
    takes at most cap = ceil(Sg * K / E * capacity_factor) choices per
    group, in the group's token-major, k-minor order, so every row routed
    (inactive slots and padding included) can take capacity from the rows
    after it. A dropped choice contributes nothing. The expert products
    are plain batched products, which ``repro`` too leaves to its
    compiler.

    Inside the sharded step (``sharding.spmd``) the layer takes
    ``repro``'s layout. With the residual's rows over "model"
    (``spmd.sp_on``) the rank's rows of the sequence are gathered first.
    Where the dispatch groups divide the batch's ranks
    (``spmd.moe_groups_split``) the rank routes its own groups, which are
    whole, so routing, slots and capacity are the mesh-free ones of those
    groups, and the aux and z losses' means over every token are sums over
    the batch's ranks; otherwise every rank's rows are gathered and the
    rank's kept at the end. With the experts over "model" (the weights'
    ``spmd.tp_split``) the rank dispatches to, runs and combines its own
    experts only, and the combine's partial sums are reduce-scattered onto
    the rank's rows (``spmd.sp_scatter``) or summed (``spmd.tp_sum``). The
    routing statistics are whole on every "model" rank: under ``sp_on``
    their gradient is sent once (``spmd.tp_once``), where every other
    gradient of the gathered rows is the rank's part."""
    sp = spmd.sp_on()
    if sp:                       # every row of the rank's sequences
        x = spmd.sp_gather(x)
    split = spmd.moe_groups_split(x.shape[0] * x.shape[1], dims.group_size)
    if not split:                # every rank's rows (all the groups)
        x = spmd.gather_rows(x)
    B, S, D = x.shape
    E, K = dims.num_experts, dims.top_k
    T = B * S
    n = spmd.batch_split() if split else 1
    xt = x.reshape(T, D)
    logits = xt.float() @ params["router"].float()                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # torch.topk and lax.top_k may order exactly tied probabilities
    # differently; router probabilities of random weights make such ties
    # improbable
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)            # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # Switch-style load balance and router z-loss: means over every token
    top1 = F.one_hot(expert_idx[:, 0], E).float()
    lse2 = torch.logsumexp(logits, dim=-1) ** 2
    if split:
        me = spmd.batch_sum(probs.sum(0)) / (T * n)
        ce = spmd.batch_sum(top1.sum(0)) / (T * n)
        z_loss = spmd.batch_sum(lse2.sum()) / (T * n)
    else:
        me, ce, z_loss = probs.mean(0), top1.mean(0), torch.mean(lse2)
    aux_loss = spmd.tp_once(E * torch.sum(me * ce))
    z_loss = spmd.tp_once(z_loss)

    G = max(1, T * n // dims.group_size) // n     # the rank's groups
    Sg = T // G
    cap = max(1, int(math.ceil(Sg * K / E * dims.capacity_factor)))
    xg = xt.reshape(G, Sg, D)
    idx_g = expert_idx.reshape(G, Sg, K)
    gate_g = gate_vals.reshape(G, Sg, K)
    # each (token, k)'s slot in its expert's buffer: the exclusive cumsum
    # of the one-hots over the group's token-major, k-minor order
    eo = F.one_hot(idx_g, E)                                   # (G,Sg,K,E)
    flat = eo.reshape(G, Sg * K, E)
    pos_in_e = (torch.cumsum(flat, dim=1) - flat).reshape(G, Sg, K, E)
    slot = (pos_in_e * eo).sum(-1)                             # (G,Sg,K)
    keep = (slot < cap) & (gate_g > 0)
    gate_g = torch.where(keep, gate_g, 0.0)
    if MOE_TRACE is not None:
        MOE_TRACE.append({"expert": expert_idx, "kept": keep.reshape(T, K),
                          "probs": probs, "cap": cap})

    w_gate, w_up, w_down = params["w_gate"], params["w_up"], params["w_down"]
    ep = spmd.tp_split(w_gate) is not None
    if ep:                       # the rank's experts [lo, lo + E / M)
        lo = spmd.model_rank() * w_gate.shape[0]
        eo = eo[..., lo:lo + w_gate.shape[0]]
        if not sp:               # a replicated x: its gradient summed
            xg, gate_g = spmd.tp_copy(xg), spmd.tp_copy(gate_g)
    # dispatch / combine one-hots (G, Sg, K, E, cap) folded over K; a slot
    # past cap has no one-hot column, as jax.nn.one_hot gives none
    slot_oh = (slot[..., None] == torch.arange(cap, device=x.device))
    kec = (eo.float()[..., None] * slot_oh.float()[..., None, :]
           * keep.float()[..., None, None])
    disp = kec.sum(2).to(x.dtype)                              # (G,Sg,E,cap)
    comb = (kec * gate_g[..., None, None]).sum(2)

    ein = torch.einsum("gsec,gsd->egcd", disp, xg)             # (E,G,cap,D)
    h = torch.einsum("egcd,edf->egcf", ein, w_gate.to(x.dtype))
    u = torch.einsum("egcd,edf->egcf", ein, w_up.to(x.dtype))
    h = silu(h) * u
    eout = torch.einsum("egcf,efd->egcd", h, w_down.to(x.dtype))
    out = torch.einsum("gsec,egcd->gsd", comb.to(x.dtype), eout)
    out = out.reshape(B, S, D)
    if not split:
        out = spmd.own_rows(out)
    if ep:                       # the experts' partial sums
        out = spmd.sp_scatter(out) if sp else spmd.tp_sum(out)
    elif sp:
        out = spmd.sp_narrow(out)
    return out, {"moe_aux": aux_loss, "moe_z": z_loss}


# ---------------------------------------------------------------- embeddings
def embed_lookup(params, ids, dtype):
    """The rows of ``ids`` (B, S); inside the sharded step with the
    residual's rows over "model" (``spmd.sp_on``) the rank's rows of the
    sequence."""
    table = params["table"]
    if spmd.tp_split(table) is not None:    # training: vocab over "model"
        return spmd.vocab_lookup(table.to(dtype), ids)
    if spmd.sp_on():
        ids = ids[:, slice(*spmd.seq_rows(ids.shape[1] // spmd.model_ways()))]
    return table.to(dtype)[ids]


def lm_logits(params_embed, x, w_unembed=None, vocab: Optional[int] = None):
    """x: (B,S,D) -> (B,S,V_padded), padding columns masked. Uses the tied
    embedding table if w_unembed is None. Inside the sharded step with the
    residual's rows over "model" x is the rank's rows, gathered first, so
    every rank gets the logits of every row."""
    if spmd.sp_on():
        x = spmd.sp_gather(x)
    w = params_embed["table"] if w_unembed is None else w_unembed
    wd = w.to(x.dtype)
    logits = spmd.tp_gather(x @ (wd.T if w_unembed is None else wd), w)
    vp = logits.shape[-1]
    if vocab is not None and vocab < vp:
        keep = torch.arange(vp, device=x.device) < vocab
        logits = torch.where(keep, logits, mask_value(logits.dtype))
    return logits
