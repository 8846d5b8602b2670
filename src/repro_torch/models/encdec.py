"""Whisper-style encoder-decoder (whisper-large-v3), counterpart of
``repro/models/encdec.py``. The conv / mel frontend is a stub, as in
``repro``: the encoder takes precomputed frame embeddings (B, S_enc, D).
Encoder: bidirectional attention, GELU MLP with biases, sinusoidal
positions. Decoder: causal self-attention, cross-attention to the encoder
states, learned positions (an 8192-row table), embeddings tied to the LM
head; LayerNorm throughout, QKV biases, no RoPE.

Serving keeps the decoder's self-attention K/V in the usual (L, B, s_max,
KV, hd) cache (or page pools) and the cross-attention K/V in per-slot
"xk" / "xv" leaves (L, B, ENC_LEN, KV, hd), computed once per request
group from the encoder's output (``precompute_cross_kv``) and read on every
decode tick. A Python loop over layers takes the place of ``lax.scan`` /
``lax.fori_loop``; the cache is written in place. There is no
``prefill_chunk_paged``: the encoder state is not page-resident, so paged
serving prefills through the transient path, as ``repro`` does.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.sharding import specs as _sp

ENC_LEN = 1500          # whisper's 30 s window of encoder frames
POS_ROWS = 8192         # rows of the decoder's learned position table


def _self_dims(cfg: ArchConfig, causal: bool) -> L.AttnDims:
    return L.AttnDims(d_model=cfg.d_model, num_heads=cfg.num_heads,
                      num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                      qkv_bias=True, rope_theta=0.0, causal=causal)


def init(cfg: ArchConfig, gen: torch.Generator, device) -> dict:
    """Random weights drawn from ``gen`` on ``device`` (``repro``'s layout
    and scales; the draws themselves differ)."""
    D = cfg.d_model

    def norm(lead):
        return L.norm_init(D, lead, device, "layernorm")

    def mlp(lead):
        return L.mlp_init(gen, D, cfg.d_ff, lead, device, gated=False,
                          bias=True)

    enc, dec = (cfg.encoder_layers,), (cfg.num_layers,)
    return {
        "embed": L.embed_init(gen, cfg.padded_vocab, D, device),
        "pos_dec": torch.randn((POS_ROWS, D), generator=gen,
                               device=device) * 0.01,
        "enc_layers": {"ln1": norm(enc),
                       "attn": L.attn_init(gen, _self_dims(cfg, False), enc,
                                           device),
                       "ln2": norm(enc), "mlp": mlp(enc)},
        "enc_norm": norm(()),
        "dec_layers": {"ln1": norm(dec),
                       "attn": L.attn_init(gen, _self_dims(cfg, True), dec,
                                           device),
                       "ln_x": norm(dec),
                       "xattn": L.attn_init(gen, _self_dims(cfg, False), dec,
                                            device),
                       "ln2": norm(dec), "mlp": mlp(dec)},
        "final_norm": norm(()),
    }


def param_logical(cfg: ArchConfig) -> dict:
    """Logical axes of every leaf of ``init``'s params, as ``repro``'s."""
    def attn(causal):
        return L.attn_logical(_self_dims(cfg, causal))
    norm, mlp = L.norm_logical("layernorm"), L.mlp_logical(gated=False,
                                                            bias=True)
    return {"embed": L.embed_logical(), "pos_dec": (None, "fsdp"),
            "enc_layers": L.stacked_logical({"ln1": norm, "attn": attn(False),
                                             "ln2": norm, "mlp": mlp}),
            "enc_norm": norm,
            "dec_layers": L.stacked_logical({
                "ln1": norm, "attn": attn(True), "ln_x": norm,
                "xattn": attn(False), "ln2": norm, "mlp": mlp}),
            "final_norm": norm}



def _sinusoid(s: int, d: int, device=None):
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _norm(x, p):
    return L.apply_norm(x, p, "layernorm")


def _enc_layer(cfg: ArchConfig, lp, x, positions, attn_impl: str):
    """One encoder layer: self-attention (not causal), then the GELU MLP."""
    x = x + L.attention(lp["attn"], _norm(x, lp["ln1"]),
                        _self_dims(cfg, False), positions, impl=attn_impl)
    return x + L.mlp(lp["mlp"], _norm(x, lp["ln2"]), act="gelu")


def encode(params, cfg: ArchConfig, frames, *, compute_dtype=torch.float32,
           attn_impl: str = "einsum", remat=False):
    """frames: (B, S_enc, D) precomputed frame embeddings -> the encoder's
    output after its final norm. ``attn_impl`` is ``layers.attention``'s
    ('pallas': the flash kernel, not causal); ``remat`` checkpoints each
    layer (``layers.remat``)."""
    B, S, _ = frames.shape
    x = (frames.to(compute_dtype)
         + _sinusoid(S, cfg.d_model, frames.device).to(compute_dtype))
    positions = torch.arange(S, device=frames.device).expand(B, S)

    body = L.remat(lambda lp, x: _enc_layer(cfg, lp, x, positions,
                                            attn_impl), remat)
    for i in range(cfg.encoder_layers):
        x = body(L.layer_params(params["enc_layers"], i), x)
    return _norm(x, params["enc_norm"])


def _cross_kv(lp_xattn, enc_out, cfg: ArchConfig):
    """One decoder layer's cross K/V (B, S_enc, KV, hd) from the encoder's
    output."""
    B, Se, _ = enc_out.shape
    shape = (B, Se, cfg.num_kv_heads, cfg.head_dim)
    k = (enc_out @ lp_xattn["wk"].to(enc_out.dtype)
         + lp_xattn["bk"].to(enc_out.dtype)).reshape(shape)
    v = (enc_out @ lp_xattn["wv"].to(enc_out.dtype)
         + lp_xattn["bv"].to(enc_out.dtype)).reshape(shape)
    return k, v


def precompute_cross_kv(params, cfg: ArchConfig, enc_out):
    """(L, B, S_enc, KV, hd) cross K and V of every decoder layer."""
    kvs = [_cross_kv(L.layer_params(params["dec_layers"], i)["xattn"],
                     enc_out, cfg) for i in range(cfg.num_layers)]
    return (torch.stack([k for k, _ in kvs]),
            torch.stack([v for _, v in kvs]))


def _cross(cfg: ArchConfig, lp, x, positions, xk, xv, enc_pos):
    """x + cross-attention of x (after ``ln_x``) to the encoder's K/V."""
    h = _norm(x, lp["ln_x"])
    return x + L.attention(lp["xattn"], h, _self_dims(cfg, False), positions,
                           impl="einsum",
                           kv_override=(xk.to(h.dtype), xv.to(h.dtype),
                                        enc_pos))


def _mlp(lp, x):
    return x + L.mlp(lp["mlp"], _norm(x, lp["ln2"]), act="gelu")


def _enc_positions(batch: int, n: int, device):
    return torch.arange(n, device=device).expand(batch, n)


def _dec_layer(cfg: ArchConfig, lp, x, positions, enc_out, enc_pos,
               attn_impl: str):
    """One decoder layer over the full sequence: causal self-attention,
    cross-attention to ``enc_out`` through this layer's cross K/V, then
    the MLP."""
    x = x + L.attention(lp["attn"], _norm(x, lp["ln1"]),
                        _self_dims(cfg, True), positions, impl=attn_impl)
    xk, xv = _cross_kv(lp["xattn"], enc_out, cfg)
    return _mlp(lp, _cross(cfg, lp, x, positions, xk, xv, enc_pos))


def _decode_layer(cfg: ArchConfig, lp, x, ck, cv, xk, xv, pos, positions,
                  enc_pos):
    """One decoder layer's decode against its dense self-attention cache
    ck / cv (written in place) and its cross K/V xk / xv."""
    out = L.attention_decode(lp["attn"], _norm(x, lp["ln1"]),
                             _self_dims(cfg, True), ck, cv, pos,
                             positions)[0]
    return _mlp(lp, _cross(cfg, lp, x + out, positions, xk, xv, enc_pos))


def forward(params, cfg: ArchConfig, tokens, *, frames=None,
            compute_dtype=torch.float32, attn_impl: str = "einsum",
            remat=False, return_features: bool = False):
    """tokens: (B, S_dec); frames: (B, S_enc, D), zeros of ENC_LEN rows
    when None. Returns (decoder logits (B, S_dec, Vp) float32, aux), or the
    features after the final norm with ``return_features``; aux holds zero
    MoE losses, as ``repro``'s. ``remat`` checkpoints each encoder and
    decoder layer (``layers.remat``)."""
    B, S = tokens.shape
    dev = tokens.device
    if frames is None:
        frames = torch.zeros((B, ENC_LEN, cfg.d_model), dtype=compute_dtype,
                             device=dev)
    enc_out = encode(params, cfg, frames, compute_dtype=compute_dtype,
                     attn_impl=attn_impl, remat=remat)
    enc_pos = _enc_positions(B, enc_out.shape[1], dev)
    pos_emb = params["pos_dec"][:min(S, POS_ROWS)]
    if S > POS_ROWS:     # tile the learned positions beyond the table
        pos_emb = pos_emb.repeat(-(-S // POS_ROWS), 1)[:S]
    x = (L.embed_lookup(params["embed"], tokens, compute_dtype)
         + pos_emb.to(compute_dtype)[None])
    positions = torch.arange(S, device=dev).expand(B, S)
    body = L.remat(lambda lp, x: _dec_layer(cfg, lp, x, positions, enc_out,
                                            enc_pos, attn_impl), remat)
    for i in range(cfg.num_layers):
        x = body(L.layer_params(params["dec_layers"], i), x)
    zero = torch.zeros((), device=dev)
    aux = {"moe_aux": zero, "moe_z": zero}
    if return_features:
        return _norm(x, params["final_norm"]), aux
    return _logits(params, cfg, x), aux


def _logits(params, cfg: ArchConfig, x):
    """Logits of the tied embeddings after the final norm."""
    x = _norm(x, params["final_norm"])
    return L.lm_logits(params["embed"], x, None,
                       vocab=cfg.vocab_size).float()


def init_cache(cfg: ArchConfig, batch: int, s_max: int,
               dtype=torch.float32, device=None):
    """Self-attention K/V (L, batch, s_max, KV, hd), the cross K/V "xk" /
    "xv" (L, batch, ENC_LEN, KV, hd) and a scalar ``pos``."""
    kv, hd, Lr = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    self_shape, cross_shape = (Lr, batch, s_max, kv, hd), (Lr, batch,
                                                           ENC_LEN, kv, hd)
    return {"k": torch.zeros(self_shape, dtype=dtype, device=device),
            "v": torch.zeros(self_shape, dtype=dtype, device=device),
            "xk": torch.zeros(cross_shape, dtype=dtype, device=device),
            "xv": torch.zeros(cross_shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}



def cache_logical(cfg: ArchConfig) -> dict:
    """Adaptive, as ``repro``'s (``transformer.cache_logical``)."""
    if cfg.num_kv_heads % max(_sp.axis_size("kv_heads"), 1) == 0:
        kv = (None, "batch", None, "kv_heads", None)
    else:
        kv = (None, "batch", "seq_sp", None, None)
    return {"k": kv, "v": kv, "xk": kv, "xv": kv, "pos": ()}

def _dec_input(params, tokens, positions, compute_dtype):
    """Token embeddings plus the learned positions, clipped at the table's
    last row."""
    x_pos = params["pos_dec"][positions.long().clamp(max=POS_ROWS - 1)]
    return (L.embed_lookup(params["embed"], tokens, compute_dtype)
            + x_pos.to(compute_dtype))


def prefill_chunk(params, cfg: ArchConfig, tokens, cache, *,
                  compute_dtype=torch.float32, attn_impl: str = "einsum",
                  first: bool = False):
    """One decoder prompt chunk at full width into a dense per-request
    cache that already holds the cross K/V (``xk`` / ``xv``, written once
    per request group by the first-chunk builder, launch/steps.py). A first
    chunk with ``attn_impl='pallas'`` runs its self-attention through the
    flash kernel. Returns (last-position logits (B, 1, Vp) float32, cache
    with ``pos`` advanced by C)."""
    B, C = tokens.shape
    dev = tokens.device
    start = 0 if first else int(cache["pos"])
    positions = start + torch.arange(C, device=dev).expand(B, C)
    use_kernel = first and attn_impl == "pallas"
    x = _dec_input(params, tokens, positions, compute_dtype)
    enc_pos = _enc_positions(B, cache["xk"].shape[2], dev)
    dims = _self_dims(cfg, True)
    for i in range(cfg.num_layers):
        lp = L.layer_params(params["dec_layers"], i)
        out, _, _ = L.attention_prefill_chunk(
            lp["attn"], _norm(x, lp["ln1"]), dims, cache["k"][i],
            cache["v"][i], start, positions, use_kernel=use_kernel)
        x = _mlp(lp, _cross(cfg, lp, x + out, positions, cache["xk"][i],
                            cache["xv"][i], enc_pos))
    cache["pos"] = torch.tensor(start + C, dtype=torch.int32, device=dev)
    return _logits(params, cfg, x[:, -1:]), cache


def decode_step(params, cfg: ArchConfig, token, cache, *, frames=None,
                compute_dtype=torch.float32, paged_attn_impl: str = "einsum"):
    """token: (B, 1). Returns (logits (B, 1, Vp) float32, cache with pos
    advanced by one), the cache written in place. ``cache["pos"]`` is a
    scalar or a (B,) per-slot vector. With a "block_tables" leaf the
    self-attention K/V are (L, P, page_size, KV, hd) page pools read
    through the paged-attention kernel (``paged_attn_impl='kernel'``) or
    the masked-einsum reference; the cross K/V stay dense per slot.
    ``frames`` is not read: the cache holds the cross K/V (``repro``'s
    step takes the batch's frames and ignores them alike)."""
    del frames
    B = token.shape[0]
    dev = token.device
    pos = cache["pos"]
    bt = cache.get("block_tables")
    positions = L.decode_positions(pos, B)
    x = _dec_input(params, token, positions, compute_dtype)
    enc_pos = _enc_positions(B, cache["xk"].shape[2], dev)
    dims = _self_dims(cfg, True)
    for i in range(cfg.num_layers):
        lp = L.layer_params(params["dec_layers"], i)
        if bt is None:
            x = _decode_layer(cfg, lp, x, cache["k"][i], cache["v"][i],
                              cache["xk"][i], cache["xv"][i], pos, positions,
                              enc_pos)
            continue
        out = L.attention_decode_paged(
            lp["attn"], _norm(x, lp["ln1"]), dims, cache["k"][i],
            cache["v"][i], bt, pos, positions, impl=paged_attn_impl)[0]
        x = _mlp(lp, _cross(cfg, lp, x + out, positions, cache["xk"][i],
                            cache["xv"][i], enc_pos))
    cache["pos"] = pos + 1
    return _logits(params, cfg, x), cache
