"""Decoder-only transformer LM, dense family (GQA or MLA attention): the
full-sequence forward and serving over a dense or a paged KV cache (fp32
or int8 pages, or MLA latent rows). Counterpart of
``repro/models/transformer.py``: layer parameters are stacked along a
leading L axis as in ``repro``, and a Python loop over layers takes the
place of ``lax.scan`` / ``lax.fori_loop``; each layer's slice of the cache
is a view, so the in-place writes land in the cache itself.

Public API (used by models.registry):
    init(cfg, gen, device)                        -> params
    forward(params, cfg, tokens, ...)             -> logits, aux
    init_cache(cfg, batch, s_max, dtype, device)  -> dense cache
    prefill_chunk(params, cfg, tokens, cache, ...) -> logits, cache
    prefill_chunk_paged(params, cfg, tokens, cache, ...) -> logits, cache
    decode_step(params, cfg, token, cache, ...)   -> logits, cache
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, Family
from repro_torch.models import layers as L


def _check_supported(cfg: ArchConfig):
    if cfg.family != Family.DENSE or cfg.cross_attn_every:
        raise NotImplementedError(
            f"family {cfg.family.value!r} is not ported yet (ROADMAP queue 1 "
            f"item 5); the port serves the dense, ssm and hybrid families")
    _is_mla(cfg)
    if cfg.norm != "rmsnorm" or cfg.mlp_bias:
        raise NotImplementedError(
            "layernorm and MLP biases are not ported yet (ROADMAP queue 1 "
            "item 5, with whisper)")


def _attn_dims(cfg: ArchConfig) -> L.AttnDims:
    return L.AttnDims(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias, window=cfg.window, rope_theta=cfg.rope_theta)


def _mla_dims(cfg: ArchConfig) -> L.MLADims:
    return L.MLADims(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        kv_lora_rank=cfg.kv_lora_rank, qk_rope_head_dim=cfg.qk_rope_head_dim,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)


def _is_mla(cfg: ArchConfig) -> bool:
    """MLA gate: a latent cache replaces per-head K/V. It is defined for
    plain causal decoder stacks only (no sliding window, no interleaved
    cross-attention)."""
    if not cfg.kv_lora_rank:
        return False
    if cfg.window or cfg.cross_attn_every:
        raise ValueError("MLA (kv_lora_rank > 0) supports only full-causal "
                         "decoder stacks (no window / cross-attn)")
    return True


def init(cfg: ArchConfig, gen: torch.Generator, device) -> dict:
    """Random weights drawn from ``gen`` on ``device`` (same layout and
    scales as ``repro``'s init; the draws themselves differ)."""
    _check_supported(cfg)
    Ln = (cfg.num_layers,)
    params = {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, device),
        "final_norm": L.norm_init(cfg.d_model, device=device),
        "layers": {
            "ln1": L.norm_init(cfg.d_model, Ln, device),
            "attn": (L.mla_init(gen, _mla_dims(cfg), Ln, device)
                     if _is_mla(cfg)
                     else L.attn_init(gen, _attn_dims(cfg), Ln, device)),
            "ln2": L.norm_init(cfg.d_model, Ln, device),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, Ln, device),
        },
    }
    if not cfg.tie_embeddings:
        params["unembed"] = {"w": L._dense(gen, (cfg.d_model, cfg.padded_vocab),
                                           cfg.d_model, device)}
    return params


def forward(params, cfg: ArchConfig, tokens, *, compute_dtype=torch.float32,
            attn_impl: str = "einsum", return_features: bool = False):
    """tokens: (B, S) at positions 0..S-1 -> (logits (B, S, Vp) float32,
    aux), or (features after the final norm, aux) with
    ``return_features``. ``attn_impl`` is ``layers.attention``'s (an MLA
    stack always runs its absorbed chunk form). ``aux`` holds the MoE
    losses ``repro`` returns, zero for the dense family."""
    B, S = tokens.shape
    x = L.embed_lookup(params["embed"], tokens, compute_dtype)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    dims = _attn_dims(cfg)
    mla = _is_mla(cfg)
    for i in range(cfg.num_layers):
        lp = L.layer_params(params["layers"], i)
        h = L.rmsnorm(x, lp["ln1"]["scale"])
        if mla:
            x = x + _mla_full_attention(cfg, lp["attn"], h, positions)
        else:
            x = x + L.attention(lp["attn"], h, dims, positions,
                                impl=attn_impl)
        x = x + L.mlp(lp["mlp"], L.rmsnorm(x, lp["ln2"]["scale"]))
    zero = torch.zeros((), device=x.device)
    aux = {"moe_aux": zero, "moe_z": zero}
    if return_features:
        return L.rmsnorm(x, params["final_norm"]["scale"]), aux
    return _logits(params, cfg, x), aux


def _mla_full_attention(cfg: ArchConfig, lp_attn, h, positions):
    """Full-sequence MLA attention: one prefill chunk spanning the whole
    sequence against a transient latent cache, in the absorbed order every
    serving path uses."""
    dims = _mla_dims(cfg)
    B, S, _ = h.shape
    cache_c = torch.zeros((B, S, 1, dims.latent_dim), dtype=h.dtype,
                          device=h.device)
    out, _ = L.mla_attention_prefill_chunk(lp_attn, h, dims, cache_c, 0,
                                           positions)
    return out


def init_cache(cfg: ArchConfig, batch: int, s_max: int,
               dtype=torch.float32, device=None):
    """Dense per-slot cache (L, batch, s_max, KV, hd) with a scalar ``pos``;
    for MLA a single latent leaf "k" (L, batch, s_max, 1, c + r) shaped as
    one kv head, with no "v" (values are the latent rows' leading c
    columns). The paged cache (registry.init_paged_cache) takes its shapes
    from here (on the ``meta`` device)."""
    _check_supported(cfg)
    if _is_mla(cfg):
        shape = (cfg.num_layers, batch, s_max, 1, _mla_dims(cfg).latent_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "pos": torch.zeros((), dtype=torch.int32, device=device)}
    shape = (cfg.num_layers, batch, s_max, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _logits(params, cfg: ArchConfig, x):
    x = L.rmsnorm(x, params["final_norm"]["scale"])
    w_un = params["unembed"]["w"] if not cfg.tie_embeddings else None
    return L.lm_logits(params["embed"], x, w_un, vocab=cfg.vocab_size).float()


def _decode_layer(cfg: ArchConfig, lp, x, ck, cv, pos, positions,
                  block_tables=None, paged_impl: str = "einsum",
                  kscale=None, vscale=None):
    """One decode layer; ck/cv are one layer's dense cache (B, S_max, KV,
    hd) or, with ``block_tables``, its (P, ps, KV, hd) page pool slice;
    ``kscale``/``vscale`` are the layer's (P, 1) scales of int8 pools."""
    h = L.rmsnorm(x, lp["ln1"]["scale"])
    if block_tables is not None:
        out = L.attention_decode_paged(
            lp["attn"], h, _attn_dims(cfg), ck, cv, block_tables, pos,
            positions, impl=paged_impl, k_scale=kscale, v_scale=vscale)[0]
    else:
        out, _, _ = L.attention_decode(lp["attn"], h, _attn_dims(cfg), ck, cv,
                                       pos, positions)
    x = x + out
    return x + L.mlp(lp["mlp"], L.rmsnorm(x, lp["ln2"]["scale"]))


def _decode_layer_mla(cfg: ArchConfig, lp, x, ck, pos, positions,
                      block_tables=None, paged_impl: str = "einsum"):
    """``_decode_layer`` over one layer's latent cache: (B, S_max, 1, c+r)
    dense rows or, with ``block_tables``, a (P, ps, 1, c+r) page pool."""
    h = L.rmsnorm(x, lp["ln1"]["scale"])
    if block_tables is not None:
        out, _ = L.mla_attention_decode_paged(
            lp["attn"], h, _mla_dims(cfg), ck, block_tables, pos, positions,
            impl=paged_impl)
    else:
        out, _ = L.mla_attention_decode(lp["attn"], h, _mla_dims(cfg), ck,
                                        pos, positions)
    x = x + out
    return x + L.mlp(lp["mlp"], L.rmsnorm(x, lp["ln2"]["scale"]))


def _prefill_chunk_layer_mla(cfg: ArchConfig, lp, x, ck, start, positions):
    h = L.rmsnorm(x, lp["ln1"]["scale"])
    out, _ = L.mla_attention_prefill_chunk(lp["attn"], h, _mla_dims(cfg), ck,
                                           start, positions)
    x = x + out
    return x + L.mlp(lp["mlp"], L.rmsnorm(x, lp["ln2"]["scale"]))


def _prefill_chunk_layer_paged_mla(cfg: ArchConfig, lp, x, pk, bt, positions,
                                   write_floor, impl):
    h = L.rmsnorm(x, lp["ln1"]["scale"])
    out, _ = L.mla_attention_prefill_chunk_paged(
        lp["attn"], h, _mla_dims(cfg), pk, bt, positions, write_floor,
        impl=impl)
    x = x + out
    return x + L.mlp(lp["mlp"], L.rmsnorm(x, lp["ln2"]["scale"]))


def _mla_layer_loop(params, cfg: ArchConfig, x, ck_all, layer_fn):
    """The MLA layer loop of decode, prefill and paged prefill: a loop over
    layers carrying x; ``layer_fn(lp, x, ck)`` writes layer i's latent
    cache slice ``ck_all[i]`` in place."""
    for i in range(cfg.num_layers):
        x = layer_fn(L.layer_params(params["layers"], i), x, ck_all[i])
    return x


def _prefill_chunk_layer(cfg: ArchConfig, lp, x, ck, cv, start: int,
                         positions, use_kernel: bool):
    """One layer over a whole prompt chunk against a dense per-request
    cache: ``_decode_layer``'s math at the chunk's width."""
    h = L.rmsnorm(x, lp["ln1"]["scale"])
    out, _, _ = L.attention_prefill_chunk(lp["attn"], h, _attn_dims(cfg), ck,
                                          cv, start, positions,
                                          use_kernel=use_kernel)
    x = x + out
    return x + L.mlp(lp["mlp"], L.rmsnorm(x, lp["ln2"]["scale"]))


def prefill_chunk(params, cfg: ArchConfig, tokens, cache, *,
                  compute_dtype=torch.float32, attn_impl: str = "einsum",
                  first: bool = False):
    """One prompt chunk into a dense per-request cache, at full width.

    tokens: (B, C), consecutive positions from ``cache["pos"]`` (from 0 for
    a ``first`` chunk). Each layer writes the chunk's K/V rows into the
    cache in place and attends every row up to each query's position; a
    first chunk with ``attn_impl='pallas'`` attends through the flash
    kernel. Returns (last-position logits (B, 1, Vp) float32, cache with
    ``pos`` advanced by C)."""
    B, C = tokens.shape
    start = 0 if first else int(cache["pos"])
    positions = start + torch.arange(C, device=tokens.device).expand(B, C)
    use_kernel = first and attn_impl == "pallas"
    x = L.embed_lookup(params["embed"], tokens, compute_dtype)
    if _is_mla(cfg):
        x = _mla_layer_loop(params, cfg, x, cache["k"],
                            lambda lp, x, ck: _prefill_chunk_layer_mla(
                                cfg, lp, x, ck, start, positions))
    else:
        for i in range(cfg.num_layers):
            lp = L.layer_params(params["layers"], i)
            x = _prefill_chunk_layer(cfg, lp, x, cache["k"][i],
                                     cache["v"][i], start, positions,
                                     use_kernel)
    cache["pos"] = torch.tensor(start + C, dtype=torch.int32,
                                device=tokens.device)
    return _logits(params, cfg, x[:, -1:]), cache


def prefill_chunk_paged(params, cfg: ArchConfig, tokens, cache, *, bt_rows,
                        start: int, write_floor: int,
                        compute_dtype=torch.float32, attn_impl: str = "kernel"):
    """One prompt chunk for a group of K slots, spliced into the RESIDENT
    paged cache incrementally.

    tokens: (K, C) consecutive prompt positions starting at ``start``;
    bt_rows: (K, mps) the group's block-table rows; ``write_floor``: rows
    below it live in shared immutable prefix pages and are not written.
    Each layer writes the chunk's K/V into the group's pages, then attends
    the pages through the block table. An int8 cache carries (L, P, 1)
    "k_scale"/"v_scale" leaves, re-quantized page by page as the chunk is
    spliced in; an MLA cache holds one latent pool "k". Returns
    (last-position logits (K, 1, Vp) float32, cache); the engine advances
    ``pos`` at job completion."""
    K, C = tokens.shape
    positions = start + torch.arange(C, device=tokens.device
                                     ).expand(K, C)
    x = L.embed_lookup(params["embed"], tokens, compute_dtype)
    if _is_mla(cfg):
        x = _mla_layer_loop(params, cfg, x, cache["k"],
                            lambda lp, x, pk: _prefill_chunk_layer_paged_mla(
                                cfg, lp, x, pk, bt_rows, positions,
                                write_floor, attn_impl))
        return _logits(params, cfg, x[:, -1:]), cache
    dims = _attn_dims(cfg)
    quantized = "k_scale" in cache
    for i in range(cfg.num_layers):
        lp = L.layer_params(params["layers"], i)
        scales = (dict(k_scale=cache["k_scale"][i],
                       v_scale=cache["v_scale"][i]) if quantized else {})
        h = L.rmsnorm(x, lp["ln1"]["scale"])
        out = L.attention_prefill_chunk_paged(
            lp["attn"], h, dims, cache["k"][i], cache["v"][i], bt_rows,
            positions, write_floor, impl=attn_impl, **scales)[0]
        x = x + out
        x = x + L.mlp(lp["mlp"], L.rmsnorm(x, lp["ln2"]["scale"]))
    return _logits(params, cfg, x[:, -1:]), cache


def decode_step(params, cfg: ArchConfig, token, cache, *,
                compute_dtype=torch.float32, paged_attn_impl: str = "einsum"):
    """token: (B, 1). Returns (logits (B, 1, Vp) float32, cache with pos
    advanced by one); the cache is written in place. ``cache["pos"]`` is a
    scalar (lockstep) or a (B,) per-slot vector. A cache with a
    "block_tables" leaf is PAGED (registry.init_paged_cache): "k"/"v" are
    (L, P, page_size, KV, hd) page pools read through the block tables —
    via the paged-attention kernel with ``paged_attn_impl='kernel'``, the
    masked-einsum reference otherwise; int8 pools come with (L, P, 1)
    "k_scale"/"v_scale" leaves. An MLA cache holds one latent leaf "k"."""
    B = token.shape[0]
    pos = cache["pos"]
    bt = cache.get("block_tables")
    positions = L.decode_positions(pos, B)
    x = L.embed_lookup(params["embed"], token, compute_dtype)
    if _is_mla(cfg):
        x = _mla_layer_loop(params, cfg, x, cache["k"],
                            lambda lp, x, ck: _decode_layer_mla(
                                cfg, lp, x, ck, pos, positions, bt,
                                paged_attn_impl))
    else:
        quantized = bt is not None and "k_scale" in cache
        for i in range(cfg.num_layers):
            scales = ((cache["k_scale"][i], cache["v_scale"][i])
                      if quantized else (None, None))
            lp = L.layer_params(params["layers"], i)
            x = _decode_layer(cfg, lp, x, cache["k"][i], cache["v"][i], pos,
                              positions, bt, paged_attn_impl, *scales)
    cache["pos"] = pos + 1
    return _logits(params, cfg, x), cache
