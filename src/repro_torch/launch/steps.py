"""Serving step builders, as in ``repro/launch/steps.py``. PyTorch runs
eagerly, so a builder returns a plain function where ``repro`` returned one
to be jitted, and a Python loop takes the place of ``lax.scan``. The
builders go through the ``Model`` facade, so they serve every family
alike: for rwkv6 and hymba the scan anchor threads the recurrent state
through ``decode_step`` token by token, and a prefill chunk carries it
across chunks in the transient cache; a VLM batch carries its
``image_embeds``; for whisper the first chunk (and the scan anchor) runs
the encoder and the cross K/V exactly once per request group."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import Family
from repro_torch.models import encdec
from repro_torch.models.registry import Model


def _batch_extras(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The frontend stub inputs a batch carries (a VLM's ``image_embeds``,
    an encoder-decoder's ``frames``), passed on to the model."""
    return {k: batch[k] for k in ("image_embeds", "frames") if k in batch}


def _with_cross_kv(model: Model, params, cache, frames, compute_dtype):
    """An encoder-decoder's transient cache with its cross K/V: the encoder
    runs once on ``frames`` (the model's zero stub when None) through the
    einsum attention, as ``repro``'s builders run it, and every decoder
    layer's cross K/V replace the cache's zero "xk" / "xv"."""
    if frames is None:
        frames = model.extra_inputs(cache["k"].shape[1], compute_dtype,
                                    cache["k"].device)["frames"]
    enc_out = encdec.encode(params, model.cfg, frames.to(compute_dtype),
                            compute_dtype=compute_dtype, attn_impl="einsum")
    xk, xv = encdec.precompute_cross_kv(params, model.cfg, enc_out)
    cache["xk"] = xk.to(cache["xk"].dtype)
    cache["xv"] = xv.to(cache["xv"].dtype)
    return cache


def head_weight(model: Model, params):
    """(weights, tied?) for the LM head."""
    if "unembed" in params:
        return params["unembed"]["w"], False
    return params["embed"]["table"], True


def make_prefill(model: Model, *, compute_dtype=torch.float32,
                 attn_impl: str = "chunked", return_cache: bool = False,
                 s_max: int = 0, cache_dtype=torch.float32):
    """Prefill step builder.

    Default: ``prefill(params, batch) -> (B, 1, Vp)`` float32 last-position
    logits of a full-sequence forward (``attn_impl`` as in
    ``layers.attention``); the padded vocab columns are not masked, as in
    ``repro``. (``repro``'s ``batch_chunks`` slicing has no caller in the
    port yet.)

    ``return_cache=True``: the scan anchor. ``prefill(params, batch) ->
    (last_logits, cache)`` teacher-forces the prompt through
    ``decode_step`` one position at a time into a fresh dense cache of
    ``s_max`` rows (scalar pos), which ends at pos == prompt_len."""
    if return_cache:
        if s_max <= 0:
            raise ValueError("return_cache=True requires s_max > 0")

        def prefill_cache(params, batch):
            tokens = batch["tokens"]
            B, S = tokens.shape
            cache = model.init_cache(B, s_max, cache_dtype,
                                     device=tokens.device)
            extras = _batch_extras(batch)
            if model.cfg.family == Family.ENCDEC:
                cache = _with_cross_kv(model, params, cache,
                                       extras.pop("frames", None),
                                       compute_dtype)
            logits = torch.zeros((B, 1, model.cfg.padded_vocab),
                                 device=tokens.device)
            for t in range(S):
                logits, cache = model.decode_step(
                    params, tokens[:, t:t + 1], cache,
                    compute_dtype=compute_dtype, **extras)
            return logits, cache
        return prefill_cache

    def prefill(params, batch):
        feats, _ = model.forward(params, batch["tokens"],
                                 compute_dtype=compute_dtype,
                                 attn_impl=attn_impl, return_features=True,
                                 **_batch_extras(batch))
        w, tied = head_weight(model, params)
        last = feats[:, -1:]
        wd = w.to(last.dtype)
        return (last @ wd.T if tied else last @ wd).float()
    return prefill


def make_prefill_chunk(model: Model, *, compute_dtype=torch.float32,
                       s_max: int = 0, cache_dtype=torch.float32,
                       first: bool = False, attn_impl: str = "einsum"):
    """Parallel chunked prefill into a dense transient request cache.

    ``first=True``: ``first_chunk(params, batch) -> (logits, cache)``
    creates the (K, s_max) cache (for an encoder-decoder, with the cross
    K/V of one encoder pass over ``batch["frames"]``) and runs the chunk at
    position 0, where ``attn_impl='pallas'`` sends the attention through
    the flash kernel. ``first=False``: ``chunk(params, cache, batch) ->
    (logits, cache)`` continues at ``cache['pos']``. The cache is written
    in place."""
    if s_max <= 0 and first:
        raise ValueError("first=True requires s_max > 0")

    def run_chunk(params, cache, batch):
        return model.prefill_chunk(params, batch["tokens"], cache,
                                   compute_dtype=compute_dtype,
                                   attn_impl=attn_impl, first=first,
                                   **_batch_extras(batch))

    if not first:
        return run_chunk

    def first_chunk(params, batch):
        tokens = batch["tokens"]
        cache = model.init_cache(tokens.shape[0], s_max, cache_dtype,
                                 device=tokens.device)
        if model.cfg.family == Family.ENCDEC:
            cache = _with_cross_kv(model, params, cache, batch.get("frames"),
                                   compute_dtype)
            batch = {k: v for k, v in batch.items() if k != "frames"}
        return run_chunk(params, cache, batch)
    return first_chunk


def make_prefill_chunk_paged(model: Model, *, compute_dtype=torch.float32,
                             attn_impl: str = "kernel"):
    """Incremental paged prefill: returns ``chunk(params, cache, batch) ->
    (last_logits, cache)``. ``batch`` carries ``tokens`` (K, C), ``bt``
    (K, mps) block-table rows, ``start`` (the chunk's first absolute
    position, shared by the group) and ``floor`` (the first row the group
    may write). The chunk's K/V land in the resident pools in place."""
    def chunk(params, cache, batch):
        return model.prefill_chunk_paged(
            params, batch["tokens"], cache, bt_rows=batch["bt"],
            start=batch["start"], write_floor=batch["floor"],
            compute_dtype=compute_dtype, attn_impl=attn_impl,
            **_batch_extras(batch))
    return chunk


def make_decode_step(model: Model, *, compute_dtype=torch.float32,
                     paged_attn_impl: Optional[str] = None):
    """One-token decode against the serving cache, updated in place.
    ``paged_attn_impl`` ('kernel' | 'einsum') selects the paged read path;
    None keeps the model's default (the masked-einsum reference). A dense
    cache ignores it."""
    extra = {}
    if paged_attn_impl is not None:
        extra["paged_attn_impl"] = paged_attn_impl

    def decode(params, cache, batch):
        return model.decode_step(params, batch["token"], cache,
                                 compute_dtype=compute_dtype, **extra,
                                 **_batch_extras(batch))
    return decode
