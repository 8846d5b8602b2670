"""Decoder-only transformer LM covering the dense, MoE and VLM (interleaved
cross-attention) families, with GQA or MLA attention: the full-sequence
forward and serving over a dense or a paged KV cache (fp32 or int8 pages,
or MLA latent rows). Counterpart of ``repro/models/transformer.py``: layer
parameters are stacked along a leading L axis as in ``repro`` (the VLM's
along (n_super, per) under ``params["super"]["blocks"]``, its cross blocks
along n_super), and a Python loop over layers takes the place of
``lax.scan`` / ``lax.fori_loop``; each layer's slice of the cache is a
view, so the in-place writes land in the cache itself.

Public API (used by models.registry):
    init(cfg, gen, device)                        -> params
    forward(params, cfg, tokens, ...)             -> logits, aux
    init_cache(cfg, batch, s_max, dtype, device)  -> dense cache
    prefill_chunk(params, cfg, tokens, cache, ...) -> logits, cache
    prefill_chunk_paged(params, cfg, tokens, cache, ...) -> logits, cache
    decode_step(params, cfg, token, cache, ...)   -> logits, cache

The VLM's serving entry points take ``image_embeds`` (B, T_img, D), the
stub frontend's precomputed image embeddings, which every cross block
projects through its own wk / wv on every call, as ``repro`` does.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, Family
from repro_torch.models import layers as L
from repro_torch.sharding import specs as _sp
from repro_torch.sharding import spmd


def _check_supported(cfg: ArchConfig):
    _is_mla(cfg)
    if cfg.cross_attn_every and cfg.num_layers % cfg.cross_attn_every:
        raise ValueError(f"num_layers {cfg.num_layers} must be a multiple of "
                         f"cross_attn_every {cfg.cross_attn_every}")


def _attn_dims(cfg: ArchConfig, causal: bool = True) -> L.AttnDims:
    return L.AttnDims(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias, window=cfg.window, rope_theta=cfg.rope_theta,
        causal=causal)


def _cross_dims(cfg: ArchConfig) -> L.AttnDims:
    """The VLM cross blocks' attention: not causal, no window, no RoPE."""
    return L.AttnDims(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias, window=0, rope_theta=0.0, causal=False)


def _mla_dims(cfg: ArchConfig) -> L.MLADims:
    return L.MLADims(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        kv_lora_rank=cfg.kv_lora_rank, qk_rope_head_dim=cfg.qk_rope_head_dim,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)


def _moe_dims(cfg: ArchConfig) -> L.MoEDims:
    return L.MoEDims(d_model=cfg.d_model, d_ff=cfg.d_ff,
                     num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                     capacity_factor=cfg.moe.capacity_factor)


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


def _gated(cfg: ArchConfig) -> bool:
    return cfg.norm == "rmsnorm" or cfg.family in (Family.DENSE, Family.MOE,
                                                   Family.VLM)


def _layer_init(gen, cfg: ArchConfig, lead, device) -> dict:
    p = {"ln1": L.norm_init(cfg.d_model, lead, device, cfg.norm),
         "attn": (L.mla_init(gen, _mla_dims(cfg), lead, device)
                  if _is_mla(cfg)
                  else L.attn_init(gen, _attn_dims(cfg), lead, device)),
         "ln2": L.norm_init(cfg.d_model, lead, device, cfg.norm)}
    if cfg.moe:
        p["moe"] = L.moe_init(gen, _moe_dims(cfg), lead, device)
    else:
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, lead, device,
                              gated=_gated(cfg), bias=cfg.mlp_bias)
    return p


def _layer_logical(cfg: ArchConfig) -> dict:
    p = {"ln1": L.norm_logical(cfg.norm),
         "attn": (L.mla_logical(_mla_dims(cfg)) if _is_mla(cfg)
                  else L.attn_logical(_attn_dims(cfg))),
         "ln2": L.norm_logical(cfg.norm)}
    if cfg.moe:
        p["moe"] = L.moe_logical()
    else:
        p["mlp"] = L.mlp_logical(gated=_gated(cfg), bias=cfg.mlp_bias)
    return p


def init(cfg: ArchConfig, gen: torch.Generator, device) -> dict:
    """Random weights drawn from ``gen`` on ``device`` (same layout and
    scales as ``repro``'s init; the draws themselves differ). A VLM's
    cross gates start at 0, as ``repro``'s do."""
    _check_supported(cfg)
    params = {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, device),
        "final_norm": L.norm_init(cfg.d_model, device=device, kind=cfg.norm),
    }
    if cfg.cross_attn_every:
        n_super = cfg.num_layers // cfg.cross_attn_every
        params["super"] = {
            "blocks": _layer_init(gen, cfg, (n_super, cfg.cross_attn_every),
                                  device),
            "cross": {"ln": L.norm_init(cfg.d_model, (n_super,), device,
                                        cfg.norm),
                      "attn": L.attn_init(gen, _cross_dims(cfg), (n_super,),
                                          device),
                      "gate": torch.zeros((n_super,), device=device)}}
    else:
        params["layers"] = _layer_init(gen, cfg, (cfg.num_layers,), device)
    if not cfg.tie_embeddings:
        params["unembed"] = {"w": L._dense(gen, (cfg.d_model, cfg.padded_vocab),
                                           cfg.d_model, device)}
    return params


def param_logical(cfg: ArchConfig) -> dict:
    """Logical axes of every leaf of ``init``'s params (``repro``'s tree:
    a VLM's blocks carry two stack axes, its cross blocks one)."""
    out = {"embed": L.embed_logical(),
           "final_norm": L.norm_logical(cfg.norm)}
    if cfg.cross_attn_every:
        out["super"] = {
            "blocks": L.stacked_logical(L.stacked_logical(
                _layer_logical(cfg))),
            "cross": L.stacked_logical({
                "ln": L.norm_logical(cfg.norm),
                "attn": L.attn_logical(_cross_dims(cfg)), "gate": ()})}
    else:
        out["layers"] = L.stacked_logical(_layer_logical(cfg))
    if not cfg.tie_embeddings:
        out["unembed"] = {"w": ("fsdp", "vocab")}
    return out


def _ffn(cfg: ArchConfig, lp, x):
    """The second half of a layer: x + ffn(norm(x)), the MoE's or the
    MLP's; returns (x, the MoE's aux losses or None)."""
    h = L.apply_norm(x, lp["ln2"], cfg.norm)
    if cfg.moe:
        y, aux = L.moe(lp["moe"], h, _moe_dims(cfg))
        return x + y, aux
    return x + L.mlp(lp["mlp"], h), None


def _cross_apply(cfg: ArchConfig, cp, x, img):
    """Gated cross-attention of x to the image embeddings img (B, T_img,
    D), projected through this block's wk / wv: x + tanh(gate) * attn."""
    h = L.apply_norm(x, cp["ln"], cfg.norm)
    B, S, _ = x.shape
    t_img = img.shape[1]
    dims = _cross_dims(cfg)
    kv_shape = (B, t_img, dims.num_kv_heads, dims.head_dim)
    k = (img @ cp["attn"]["wk"].to(x.dtype)).reshape(kv_shape)
    v = (img @ cp["attn"]["wv"].to(x.dtype)).reshape(kv_shape)
    img_pos = torch.zeros((B, t_img), dtype=torch.long, device=x.device)
    out = L.attention(cp["attn"], h, dims,
                      torch.zeros((B, S), dtype=torch.long, device=x.device),
                      impl="einsum", kv_override=(k, v, img_pos))
    return x + torch.tanh(cp["gate"]).to(x.dtype) * out


def _image(cfg: ArchConfig, image_embeds, compute_dtype):
    if not cfg.cross_attn_every:
        return None
    if image_embeds is None:
        raise ValueError(f"{cfg.name} needs image_embeds (B, "
                         f"{cfg.num_image_tokens}, {cfg.d_model})")
    return image_embeds.to(compute_dtype)


def _super_apply(cfg: ArchConfig, sp, x, img, block_fn):
    """One VLM super-layer: ``block_fn(i, lp, x) -> x`` over its
    cross_attn_every decoder blocks (i the block's index in the
    super-layer), then its cross block. Every VLM path runs its
    super-layers through this body, and so do the dry run's probes."""
    for i in range(cfg.cross_attn_every):
        x = block_fn(i, L.layer_params(sp["blocks"], i), x)
    return _cross_apply(cfg, sp["cross"], x, img)


def _layer_loop(params, cfg: ArchConfig, x, layer_fn, img=None):
    """Every layer in order: ``layer_fn(li, lp, x) -> x`` with li the flat
    layer index (a cache's leading axis stays (L, ...): layer li of a VLM
    is block li % per of super-layer li // per, and its slice of the cache
    is a view, as ``repro`` views it as (n_super, per, ...)); a VLM runs
    :func:`_super_apply`, its cross block after each super-layer."""
    if not cfg.cross_attn_every:
        for i in range(cfg.num_layers):
            x = layer_fn(i, L.layer_params(params["layers"], i), x)
        return x
    per = cfg.cross_attn_every
    for s in range(cfg.num_layers // per):
        x = _super_apply(cfg, L.layer_params(params["super"], s), x, img,
                         lambda i, lp, x, base=s * per:
                         layer_fn(base + i, lp, x))
    return x


def _layer_apply(cfg: ArchConfig, lp, x, positions, attn_impl: str):
    """One decoder layer over the full sequence: (x, the MoE's aux losses
    or None)."""
    h = L.apply_norm(x, lp["ln1"], cfg.norm)
    if _is_mla(cfg):
        x = x + _mla_full_attention(cfg, lp["attn"], h, positions)
    else:
        x = x + L.attention(lp["attn"], h, _attn_dims(cfg), positions,
                            impl=attn_impl)
    return _ffn(cfg, lp, x)


def forward(params, cfg: ArchConfig, tokens, *, image_embeds=None,
            compute_dtype=torch.float32, attn_impl: str = "einsum",
            remat=False, return_features: bool = False):
    """tokens: (B, S) at positions 0..S-1 -> (logits (B, S, Vp) float32,
    aux), or (features after the final norm, aux) with
    ``return_features``. ``attn_impl`` is ``layers.attention``'s (an MLA
    stack always runs its absorbed chunk form; cross blocks always the
    einsum). ``aux`` holds the MoE losses summed over layers, zero for a
    family without experts. ``remat`` (``layers.remat``) checkpoints each
    layer's body for training, and a VLM's whole super-layer around its
    checkpointed layers, as ``repro`` nests them (so a super-layer's
    layers run forward three times in a training step, as there). Inside
    the sharded step with the rows over "model" (``spmd.sp_on``, the
    dense and MoE decoders) the residual, the final norm and the features
    are the rank's rows, where ``repro`` shards them over "seq_sp"; the
    MoE's aux losses are the global ones on every rank."""
    B, S = tokens.shape
    x = L.embed_lookup(params["embed"], tokens, compute_dtype)
    lo, hi = spmd.seq_rows(x.shape[1])    # the rank's rows under sp
    positions = torch.arange(lo, hi, device=tokens.device).expand(B, hi - lo)
    auxes = []
    body = L.remat(lambda lp, x: _layer_apply(cfg, lp, x, positions,
                                              attn_impl), remat)
    if cfg.cross_attn_every:
        img = _image(cfg, image_embeds, compute_dtype)

        super_body = L.remat(lambda sp, x: _super_apply(
            cfg, sp, x, img, lambda _, lp, x: body(lp, x)[0]), remat)
        for s in range(cfg.num_layers // cfg.cross_attn_every):
            x = super_body(L.layer_params(params["super"], s), x)
    else:
        for i in range(cfg.num_layers):
            x, aux = body(L.layer_params(params["layers"], i), x)
            auxes.append(aux)
    if cfg.moe:
        aux = {key: torch.stack([a[key] for a in auxes]).sum()
               for key in ("moe_aux", "moe_z")}
    else:
        zero = torch.zeros((), device=x.device)
        aux = {"moe_aux": zero, "moe_z": zero}
    if return_features:
        return L.apply_norm(x, params["final_norm"], cfg.norm), aux
    return _logits(params, cfg, x), aux


def _mla_full_attention(cfg: ArchConfig, lp_attn, h, positions):
    """Full-sequence MLA attention: one prefill chunk spanning the whole
    sequence against a transient latent cache, in the absorbed order every
    serving path uses."""
    dims = _mla_dims(cfg)
    sp = spmd.sp_on()       # the rank's rows: every row's, then its own
    if sp:
        h, positions = spmd.sp_gather(h), spmd.full_positions(positions)
    B, S, _ = h.shape
    cache_c = torch.zeros((B, S, 1, dims.latent_dim), dtype=h.dtype,
                          device=h.device)
    out, _ = L.mla_attention_prefill_chunk(lp_attn, h, dims, cache_c, 0,
                                           positions)
    return spmd.sp_narrow(out) if sp else out


def init_cache(cfg: ArchConfig, batch: int, s_max: int,
               dtype=torch.float32, device=None):
    """Dense per-slot cache (L, batch, s_max, KV, hd) with a scalar ``pos``
    (a VLM's too: its layers are flat along L here); for MLA a single
    latent leaf "k" (L, batch, s_max, 1, c + r) shaped as one kv head, with
    no "v" (values are the latent rows' leading c columns). The paged
    cache (registry.init_paged_cache) takes its shapes from here (on the
    ``meta`` device)."""
    _check_supported(cfg)
    if _is_mla(cfg):
        shape = (cfg.num_layers, batch, s_max, 1, _mla_dims(cfg).latent_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "pos": torch.zeros((), dtype=torch.int32, device=device)}
    shape = (cfg.num_layers, batch, s_max, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def cache_logical(cfg: ArchConfig) -> dict:
    """Adaptive, as ``repro``'s: kv heads sharded where they divide the
    active mesh's "kv_heads" size, else the cache's sequence dim."""
    if _is_mla(cfg):
        return {"k": (None, "batch", None, None, None), "pos": ()}
    if cfg.num_kv_heads % max(_sp.axis_size("kv_heads"), 1) == 0:
        kv = (None, "batch", None, "kv_heads", None)
    else:
        kv = (None, "batch", "seq_sp", None, None)
    return {"k": kv, "v": kv, "pos": ()}


def _logits(params, cfg: ArchConfig, x):
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    w_un = params["unembed"]["w"] if not cfg.tie_embeddings else None
    return L.lm_logits(params["embed"], x, w_un, vocab=cfg.vocab_size).float()


def _decode_layer(cfg: ArchConfig, lp, x, ck, cv, pos, positions,
                  block_tables=None, paged_impl: str = "einsum",
                  kscale=None, vscale=None):
    """One decode layer; ck/cv are one layer's dense cache (B, S_max, KV,
    hd) or, with ``block_tables``, its (P, ps, KV, hd) page pool slice;
    ``kscale``/``vscale`` are the layer's (P, 1) scales of int8 pools."""
    h = L.apply_norm(x, lp["ln1"], cfg.norm)
    if block_tables is not None:
        out = L.attention_decode_paged(
            lp["attn"], h, _attn_dims(cfg), ck, cv, block_tables, pos,
            positions, impl=paged_impl, k_scale=kscale, v_scale=vscale)[0]
    else:
        out, _, _ = L.attention_decode(lp["attn"], h, _attn_dims(cfg), ck, cv,
                                       pos, positions)
    return _ffn(cfg, lp, x + out)[0]


def _decode_layer_mla(cfg: ArchConfig, lp, x, ck, pos, positions,
                      block_tables=None, paged_impl: str = "einsum"):
    """``_decode_layer`` over one layer's latent cache: (B, S_max, 1, c+r)
    dense rows or, with ``block_tables``, a (P, ps, 1, c+r) page pool."""
    h = L.apply_norm(x, lp["ln1"], cfg.norm)
    if block_tables is not None:
        out, _ = L.mla_attention_decode_paged(
            lp["attn"], h, _mla_dims(cfg), ck, block_tables, pos, positions,
            impl=paged_impl)
    else:
        out, _ = L.mla_attention_decode(lp["attn"], h, _mla_dims(cfg), ck,
                                        pos, positions)
    return _ffn(cfg, lp, x + out)[0]


def _prefill_chunk_layer_mla(cfg: ArchConfig, lp, x, ck, start, positions):
    h = L.apply_norm(x, lp["ln1"], cfg.norm)
    out, _ = L.mla_attention_prefill_chunk(lp["attn"], h, _mla_dims(cfg), ck,
                                           start, positions)
    return _ffn(cfg, lp, x + out)[0]


def _prefill_chunk_layer_paged_mla(cfg: ArchConfig, lp, x, pk, bt, positions,
                                   write_floor, impl):
    h = L.apply_norm(x, lp["ln1"], cfg.norm)
    out, _ = L.mla_attention_prefill_chunk_paged(
        lp["attn"], h, _mla_dims(cfg), pk, bt, positions, write_floor,
        impl=impl)
    return _ffn(cfg, lp, x + out)[0]


def _prefill_chunk_layer(cfg: ArchConfig, lp, x, ck, cv, start: int,
                         positions, use_kernel: bool):
    """One layer over a whole prompt chunk against a dense per-request
    cache: ``_decode_layer``'s math at the chunk's width."""
    h = L.apply_norm(x, lp["ln1"], cfg.norm)
    out, _, _ = L.attention_prefill_chunk(lp["attn"], h, _attn_dims(cfg), ck,
                                          cv, start, positions,
                                          use_kernel=use_kernel)
    return _ffn(cfg, lp, x + out)[0]


def _prefill_chunk_layer_paged(cfg: ArchConfig, lp, x, pk, pv, bt, positions,
                               write_floor: int, impl: str, kscale=None,
                               vscale=None):
    """One layer over a prompt chunk attending the paged pool directly (the
    chunk's K/V rows are spliced into the group's pages first)."""
    h = L.apply_norm(x, lp["ln1"], cfg.norm)
    scales = ({} if kscale is None
              else dict(k_scale=kscale, v_scale=vscale))
    out = L.attention_prefill_chunk_paged(
        lp["attn"], h, _attn_dims(cfg), pk, pv, bt, positions, write_floor,
        impl=impl, **scales)[0]
    return _ffn(cfg, lp, x + out)[0]


def prefill_chunk(params, cfg: ArchConfig, tokens, cache, *,
                  image_embeds=None, compute_dtype=torch.float32,
                  attn_impl: str = "einsum", first: bool = False):
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
        x = _layer_loop(params, cfg, x,
                        lambda i, lp, x: _prefill_chunk_layer_mla(
                            cfg, lp, x, cache["k"][i], start, positions))
    else:
        x = _layer_loop(params, cfg, x,
                        lambda i, lp, x: _prefill_chunk_layer(
                            cfg, lp, x, cache["k"][i], cache["v"][i], start,
                            positions, use_kernel),
                        _image(cfg, image_embeds, compute_dtype))
    cache["pos"] = torch.tensor(start + C, dtype=torch.int32,
                                device=tokens.device)
    return _logits(params, cfg, x[:, -1:]), cache


def prefill_chunk_paged(params, cfg: ArchConfig, tokens, cache, *, bt_rows,
                        start: int, write_floor: int, image_embeds=None,
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
        x = _layer_loop(params, cfg, x,
                        lambda i, lp, x: _prefill_chunk_layer_paged_mla(
                            cfg, lp, x, cache["k"][i], bt_rows, positions,
                            write_floor, attn_impl))
        return _logits(params, cfg, x[:, -1:]), cache
    quantized = "k_scale" in cache

    def layer(i, lp, x):
        scales = ((cache["k_scale"][i], cache["v_scale"][i]) if quantized
                  else (None, None))
        return _prefill_chunk_layer_paged(
            cfg, lp, x, cache["k"][i], cache["v"][i], bt_rows, positions,
            write_floor, attn_impl, *scales)

    x = _layer_loop(params, cfg, x, layer,
                    _image(cfg, image_embeds, compute_dtype))
    return _logits(params, cfg, x[:, -1:]), cache


def decode_step(params, cfg: ArchConfig, token, cache, *, image_embeds=None,
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
        x = _layer_loop(params, cfg, x,
                        lambda i, lp, x: _decode_layer_mla(
                            cfg, lp, x, cache["k"][i], pos, positions, bt,
                            paged_attn_impl))
    else:
        quantized = bt is not None and "k_scale" in cache

        def layer(i, lp, x):
            scales = ((cache["k_scale"][i], cache["v_scale"][i])
                      if quantized else (None, None))
            return _decode_layer(cfg, lp, x, cache["k"][i], cache["v"][i],
                                 pos, positions, bt, paged_attn_impl, *scales)

        x = _layer_loop(params, cfg, x, layer,
                        _image(cfg, image_embeds, compute_dtype))
    cache["pos"] = pos + 1
    return _logits(params, cfg, x), cache
