"""Decoder-only transformer LM, dense family: the full-sequence forward and
serving over a dense or a paged KV cache. Counterpart of
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
            f"items 5 and 9); the port serves the dense family")
    if cfg.kv_lora_rank:
        raise NotImplementedError(
            "MLA latent attention is not ported yet (ROADMAP queue 1 item 7)")
    if cfg.norm != "rmsnorm" or cfg.mlp_bias:
        raise NotImplementedError(
            "layernorm and MLP biases are not ported yet (ROADMAP queue 1 "
            "item 5, with whisper)")


def _attn_dims(cfg: ArchConfig) -> L.AttnDims:
    return L.AttnDims(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias, window=cfg.window, rope_theta=cfg.rope_theta)


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
            "attn": L.attn_init(gen, _attn_dims(cfg), Ln, device),
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
    ``return_features``. ``attn_impl`` is ``layers.attention``'s. ``aux``
    holds the MoE losses ``repro`` returns, zero for the dense family."""
    B, S = tokens.shape
    x = L.embed_lookup(params["embed"], tokens, compute_dtype)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    dims = _attn_dims(cfg)
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        x = x + L.attention(lp["attn"], L.rmsnorm(x, lp["ln1"]["scale"]),
                            dims, positions, impl=attn_impl)
        x = x + L.mlp(lp["mlp"], L.rmsnorm(x, lp["ln2"]["scale"]))
    zero = torch.zeros((), device=x.device)
    aux = {"moe_aux": zero, "moe_z": zero}
    if return_features:
        return L.rmsnorm(x, params["final_norm"]["scale"]), aux
    return _logits(params, cfg, x), aux


def init_cache(cfg: ArchConfig, batch: int, s_max: int,
               dtype=torch.float32, device=None):
    """Dense per-slot cache (L, batch, s_max, KV, hd) with a scalar ``pos``;
    the paged cache (registry.init_paged_cache) takes its shapes from here
    (on the ``meta`` device)."""
    _check_supported(cfg)
    shape = (cfg.num_layers, batch, s_max, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _layer(tree, i: int):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _logits(params, cfg: ArchConfig, x):
    x = L.rmsnorm(x, params["final_norm"]["scale"])
    w_un = params["unembed"]["w"] if not cfg.tie_embeddings else None
    return L.lm_logits(params["embed"], x, w_un, vocab=cfg.vocab_size).float()


def _decode_layer(cfg: ArchConfig, lp, x, ck, cv, pos, positions,
                  block_tables=None, paged_impl: str = "einsum"):
    """One decode layer; ck/cv are one layer's dense cache (B, S_max, KV,
    hd) or, with ``block_tables``, its (P, ps, KV, hd) page pool slice."""
    h = L.rmsnorm(x, lp["ln1"]["scale"])
    if block_tables is not None:
        out, _, _ = L.attention_decode_paged(
            lp["attn"], h, _attn_dims(cfg), ck, cv, block_tables, pos,
            positions, impl=paged_impl)
    else:
        out, _, _ = L.attention_decode(lp["attn"], h, _attn_dims(cfg), ck, cv,
                                       pos, positions)
    x = x + out
    return x + L.mlp(lp["mlp"], L.rmsnorm(x, lp["ln2"]["scale"]))


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
    for i in range(cfg.num_layers):
        x = _prefill_chunk_layer(cfg, _layer(params["layers"], i), x,
                                 cache["k"][i], cache["v"][i], start,
                                 positions, use_kernel)
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
    the pages through the block table. Returns (last-position logits
    (K, 1, Vp) float32, cache); the engine advances ``pos`` at job
    completion."""
    K, C = tokens.shape
    positions = start + torch.arange(C, device=tokens.device
                                     ).expand(K, C)
    x = L.embed_lookup(params["embed"], tokens, compute_dtype)
    dims = _attn_dims(cfg)
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        h = L.rmsnorm(x, lp["ln1"]["scale"])
        out, _, _ = L.attention_prefill_chunk_paged(
            lp["attn"], h, dims, cache["k"][i], cache["v"][i], bt_rows,
            positions, write_floor, impl=attn_impl)
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
    masked-einsum reference otherwise."""
    B = token.shape[0]
    pos = cache["pos"]
    bt = cache.get("block_tables")
    positions = L.decode_positions(pos, B)
    x = L.embed_lookup(params["embed"], token, compute_dtype)
    for i in range(cfg.num_layers):
        x = _decode_layer(cfg, _layer(params["layers"], i), x, cache["k"][i],
                          cache["v"][i], pos, positions, bt, paged_attn_impl)
    cache["pos"] = pos + 1
    return _logits(params, cfg, x), cache
