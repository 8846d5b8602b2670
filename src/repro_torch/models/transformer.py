"""Decoder-only transformer LM, dense family, on the paged serving path.
Counterpart of ``repro/models/transformer.py``: layer parameters are
stacked along a leading L axis as in ``repro``, and a Python loop over
layers takes the place of ``lax.fori_loop``; each layer's slice of the page
pools is a view, so the in-place page writes land in the cache itself.

Public API (used by models.registry):
    init(cfg, gen, device)                        -> params
    init_cache(cfg, batch, s_max, dtype, device)  -> dense cache (shapes)
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


def init_cache(cfg: ArchConfig, batch: int, s_max: int,
               dtype=torch.float32, device=None):
    """Dense per-slot cache; the paged cache (registry.init_paged_cache)
    takes its shapes from here (on the ``meta`` device)."""
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
    advanced by one). The cache must be PAGED (registry.init_paged_cache):
    "k"/"v" are (L, P, page_size, KV, hd) page pools, written in place, and
    attention reads them through the block tables — via the paged-attention
    kernel with ``paged_attn_impl='kernel'``, the masked-einsum reference
    otherwise."""
    if "block_tables" not in cache:
        raise NotImplementedError("decode from a dense cache is not ported "
                                  "yet (ROADMAP queue 1 item 4)")
    B = token.shape[0]
    pos = cache["pos"]
    bt = cache["block_tables"]
    positions = L.decode_positions(pos, B)
    x = L.embed_lookup(params["embed"], token, compute_dtype)
    dims = _attn_dims(cfg)
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        h = L.rmsnorm(x, lp["ln1"]["scale"])
        out, _, _ = L.attention_decode_paged(
            lp["attn"], h, dims, cache["k"][i], cache["v"][i], bt, pos,
            positions, impl=paged_attn_impl)
        x = x + out
        x = x + L.mlp(lp["mlp"], L.rmsnorm(x, lp["ln2"]["scale"]))
    cache["pos"] = pos + 1
    return _logits(params, cfg, x), cache
