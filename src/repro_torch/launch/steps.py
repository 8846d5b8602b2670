"""The step factories of ``repro/launch/steps.py``: the training step
(loss, gradients, AdamW, microbatch accumulation, remat) and the serving
steps. PyTorch runs eagerly, so each ``make_*`` returns a plain function
where ``repro`` returned one to be jitted, and a Python loop takes the
place of ``lax.scan``. They go through the ``Model`` facade, so they
serve every family alike: for rwkv6 and hymba the scan anchor threads the
recurrent state through ``decode_step`` token by token, and a prefill
chunk carries it across chunks in the transient cache; a VLM batch carries
its ``image_embeds``; for whisper the first chunk (and the scan anchor)
runs the encoder and the cross K/V exactly once per request group."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import Family
from repro_torch.kernels.ref import mask_value
from repro_torch.models import encdec
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import AdamW, apply_updates
from repro_torch.tree import tree_leaves, tree_map

MOE_AUX_WEIGHT = 0.01
MOE_Z_WEIGHT = 1e-3


# ------------------------------------------------------------------ loss
CE_CHUNK = 1024


def cross_entropy(logits, labels):
    """logits: (B, S, V) fp32; labels: (B, S) int. The mean over tokens of
    logsumexp - the gold logit."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def head_ce_chunk(x_c, head_w, labels_c, vocab: int, tied: bool):
    """CE summed over one sequence chunk without keeping logits alive.
    x_c: (B, C, D); head_w: (D, Vp) or the tied table (Vp, D); labels_c:
    (B, C). Padded vocab columns are masked at ``mask_value``."""
    w = head_w.to(x_c.dtype)
    logits = (x_c @ w.T if tied else x_c @ w).float()
    vp = logits.shape[-1]
    if vocab < vp:
        keep = torch.arange(vp, device=logits.device) < vocab
        logits = torch.where(keep, logits, mask_value(logits.dtype))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_c[..., None].long())[..., 0]
    return torch.sum(lse - gold)


def chunked_cross_entropy(features, head_w, labels, vocab: int, tied: bool,
                          chunk: int = CE_CHUNK):
    """Never materializes (B, S, V) logits: S in chunks, each chunk's body
    checkpointed (its logits recomputed in the backward, as ``repro``'s
    ``nothing_saveable`` remat does), the chunk sums added in order, then
    divided by B * S."""
    B, S, D = features.shape
    chunk = min(chunk, S)
    n = S // chunk

    def body(x_c, l_c):
        return checkpoint(head_ce_chunk, x_c, head_w, l_c, vocab, tied,
                          use_reentrant=False)

    total = torch.zeros((), dtype=torch.float32, device=features.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + body(features[:, sl], labels[:, sl])
    if S - n * chunk:
        total = total + body(features[:, n * chunk:], labels[:, n * chunk:])
    return total / (B * S)


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


def make_prefill(model: Model, *, compute_dtype=torch.bfloat16,
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


def make_prefill_chunk(model: Model, *, compute_dtype=torch.bfloat16,
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


def make_prefill_chunk_paged(model: Model, *, compute_dtype=torch.bfloat16,
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


def make_decode_step(model: Model, *, compute_dtype=torch.bfloat16,
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


# ------------------------------------------------------------------ train
def _train_kw(model: Model) -> dict:
    """The recurrent families train through their plain scans: K5 and K6
    have no backward (``repro``'s Pallas scans have none either)."""
    if model.cfg.family in (Family.SSM, Family.HYBRID):
        return {"scan_impl": "scan"}
    return {}


def make_loss_fn(model: Model, *, compute_dtype=torch.bfloat16,
                 attn_impl: str = "einsum", remat=True):
    """``loss_fn(params, batch) -> (loss, metrics)``: the chunked CE of the
    head over the final features, plus the MoE's aux and z losses at
    ``MOE_AUX_WEIGHT`` / ``MOE_Z_WEIGHT``."""
    def loss_fn(params, batch):
        feats, aux = model.forward(params, batch["tokens"],
                                   compute_dtype=compute_dtype,
                                   attn_impl=attn_impl, remat=remat,
                                   return_features=True, **_train_kw(model),
                                   **_batch_extras(batch))
        w, tied = head_weight(model, params)
        ce = chunked_cross_entropy(feats, w, batch["labels"],
                                   model.cfg.vocab_size, tied)
        loss = (ce + MOE_AUX_WEIGHT * aux["moe_aux"]
                + MOE_Z_WEIGHT * aux["moe_z"])
        return loss, {"ce": ce, **aux}
    return loss_fn


def value_and_grad(loss_fn):
    """``repro``'s ``jax.value_and_grad(loss_fn, has_aux=True)`` over a
    param tree: ``((loss, metrics), grads)`` with grads in the params'
    nesting (zeros for a leaf the loss does not reach) and everything
    returned detached."""
    def run(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = loss_fn(leaves, batch)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        by_id = {id(p): (torch.zeros_like(p) if g is None else g)
                 for p, g in zip(flat, grads)}
        return ((loss.detach(), tree_map(torch.Tensor.detach, metrics)),
                tree_map(lambda p: by_id[id(p)], leaves))
    return run


def init_train_state(model: Model, optimizer: AdamW, gen: torch.Generator,
                     device) -> Dict[str, Any]:
    """Params drawn from ``gen`` on ``device``, AdamW's zero state and step
    0 (int32), ``repro``'s layout."""
    params = model.init(gen, device)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def make_train_step(model: Model, optimizer: AdamW, *,
                    compute_dtype=torch.bfloat16, attn_impl: str = "einsum",
                    remat=True, microbatches: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    With microbatches > 1 the batch is split along its first axis and the
    gradients (and losses) of the slices are summed in order from zero,
    then divided by ``microbatches``, as ``repro``'s ``lax.scan`` does;
    the other metrics are the last slice's."""
    grad_fn = value_and_grad(make_loss_fn(
        model, compute_dtype=compute_dtype, attn_impl=attn_impl,
        remat=remat))

    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            (loss, metrics), grads = grad_fn(params, batch)
        else:
            size = next(iter(batch.values())).shape[0] // microbatches
            loss = torch.zeros((), device=state["step"].device)
            grads = tree_map(torch.zeros_like, params)
            for i in range(microbatches):
                mbatch = {k: v[i * size:(i + 1) * size]
                          for k, v in batch.items()}
                (mloss, metrics), mgrads = grad_fn(params, mbatch)
                grads = tree_map(torch.add, grads, mgrads)
                loss = loss + mloss
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        updates, opt, gnorm = optimizer.update(grads, state["opt"], params)
        params = apply_updates(params, updates)
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm, **metrics}

    return train_step
