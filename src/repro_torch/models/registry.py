"""Model facade and the serving caches, as in ``repro/models/registry.py``.
Every LM family of ``repro`` is served: the transformer module runs the
dense, MoE and VLM families, ``encdec`` whisper, ``ssm`` rwkv6 and
``hybrid`` hymba (ResNet20 runs through ``models.resnet`` directly).

Cache conventions (shared with ``repro``). DENSE: "k"/"v" are (L, B, S,
KV, hd) and "pos" is a scalar (a lockstep batch, a transient prefill
cache) or a (B,) int32 per-slot vector (the serving cache). PAGED: the K/V
leaves are shared page pools (L, num_pages, page_size, KV, hd) with no
batch axis, addressed through a "block_tables" leaf (B,
max_pages_per_slot) int32 (-1 = unallocated). A serving slot's "pos"
starts at ``layers.INACTIVE_POS``; its writes are dropped until it is
admitted. An MLA cache has a single latent leaf "k" (one (c + r)-wide
row per token, shaped as one kv head) and no "v"; every splice below is
generic over the pool leaves the cache holds. Recurrent leaves (rwkv's
"S" / "x_tm" / "x_cm", hymba's "h" / "conv") and whisper's cross K/V
("xk" / "xv", (L, B, ENC_LEN, KV, hd)) are per slot, (L, B, ...), and
splice on the batch axis in both layouts; hymba's ring positions
"slot_pos" page with its K/V. The splices write the resident cache IN
PLACE.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import (ArchConfig, Family, MoEConfig,
                                     ShapeConfig)
from repro_torch.models import encdec, hybrid, ssm, transformer
from repro_torch.models.encdec import ENC_LEN
from repro_torch.models.layers import INACTIVE_POS

_FAMILY_MODULES = {
    Family.DENSE: transformer,
    Family.MOE: transformer,
    Family.VLM: transformer,
    Family.ENCDEC: encdec,
    Family.SSM: ssm,
    Family.HYBRID: hybrid,
}

# pool leaves of a paged cache (when "block_tables" is present); everything
# else keeps the dense (L, B, ...) per-slot layout
PAGED_POOL_LEAVES = ("k", "v", "slot_pos")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    mod: Any

    def init(self, gen: torch.Generator, device):
        return self.mod.init(self.cfg, gen, device)

    def init_cache(self, batch: int, s_max: int, dtype=torch.float32,
                   device=None):
        return self.mod.init_cache(self.cfg, batch, s_max, dtype, device)

    def param_logical(self):
        """Logical axes of every param leaf (``sharding.specs``)."""
        return self.mod.param_logical(self.cfg)

    def cache_logical(self):
        """Logical axes of the dense cache's leaves under the active mesh."""
        return self.mod.cache_logical(self.cfg)

    def forward(self, params, tokens, **kw):
        return self.mod.forward(params, self.cfg, tokens, **kw)

    def decode_step(self, params, token, cache, **kw):
        return self.mod.decode_step(params, self.cfg, token, cache, **kw)

    def prefill_chunk(self, params, tokens, cache, **kw):
        return self.mod.prefill_chunk(params, self.cfg, tokens, cache, **kw)

    @property
    def supports_paged_prefill(self) -> bool:
        """True for the families whose prompt state is exactly (k, v, pos)
        and whose chunks can splice straight into pages (dense, MoE, VLM):
        hybrid's recurrent carry and encdec's cross K/V are not
        page-resident."""
        return hasattr(self.mod, "prefill_chunk_paged")

    def prefill_chunk_paged(self, params, tokens, cache, **kw):
        return self.mod.prefill_chunk_paged(params, self.cfg, tokens, cache,
                                            **kw)

    def extra_inputs(self, batch: int, dtype=torch.float32,
                     device=None) -> dict:
        """The modality frontends' stub inputs as zeros: a VLM's
        precomputed image embeddings (batch, num_image_tokens, D), an
        encoder-decoder's frame embeddings (batch, ENC_LEN, D)."""
        cfg = self.cfg
        if cfg.family == Family.VLM:
            return {"image_embeds": torch.zeros(
                (batch, cfg.num_image_tokens, cfg.d_model), dtype=dtype,
                device=device)}
        if cfg.family == Family.ENCDEC:
            return {"frames": torch.zeros((batch, ENC_LEN, cfg.d_model),
                                          dtype=dtype, device=device)}
        return {}

    def input_specs(self, shape: ShapeConfig, dtype=torch.bfloat16,
                    device="meta") -> dict:
        """Every model input of a shape cell as tensors without data (on
        the ``meta`` device, or fake tensors when a ``FakeTensorMode`` is
        active and ``device`` is a real one), with ``repro``'s keys, shapes
        and dtypes: int32 ``tokens`` / ``labels`` (B, S) for train,
        ``tokens`` for prefill, ``token`` (B, 1) for decode, plus the
        frontend stubs of ``extra_inputs`` in ``dtype``."""
        B, S = shape.global_batch, shape.seq_len
        ids = dict(dtype=torch.int32, device=device)
        if shape.kind == "train":
            specs = {"tokens": torch.empty((B, S), **ids),
                     "labels": torch.empty((B, S), **ids)}
        elif shape.kind == "prefill":
            specs = {"tokens": torch.empty((B, S), **ids)}
        else:       # decode: one new token against a cache of length S
            specs = {"token": torch.empty((B, 1), **ids)}
        specs.update(self.extra_inputs(B, dtype, device))
        return specs


def get_model(cfg: ArchConfig) -> Model:
    if cfg.family == Family.CNN:
        raise ValueError("resnet20 uses models.resnet directly (the paper's "
                         "pipeline)")
    mod = _FAMILY_MODULES[cfg.family]
    if mod is transformer:
        transformer._check_supported(cfg)
    return Model(cfg=cfg, mod=mod)


def vectorize_cache_pos(cache, batch: int, inactive: bool = False):
    """Scalar-pos cache (init_cache output) -> per-slot (B,) positions for
    continuous-batching decode; ``inactive=True`` starts every slot at
    INACTIVE_POS (nothing admitted yet)."""
    pos = cache["pos"]
    if pos.dim() == 0:
        fill = INACTIVE_POS if inactive else int(pos)
        cache["pos"] = torch.full((batch,), fill, dtype=torch.int32,
                                  device=pos.device)
    return cache


def insert_cache_rows(cache, request_cache, slots):
    """Write a batch-K transient prefill cache into rows ``slots`` ((K,)
    int64 tensor) of a dense serving cache, in place; other slots are
    untouched bit for bit. Returns ``cache``."""
    for key, leaf in cache.items():
        req = request_cache[key]
        if key == "pos":            # a scalar (all K at prompt_len) or (K,)
            leaf[slots] = req.to(leaf.dtype)
        else:
            leaf[:, slots] = req.to(leaf.dtype)
    return cache


def insert_cache_rows_paged(cache, request_cache, slots, phys_rows):
    """Paged twin of insert_cache_rows: splice a batch-K dense transient
    cache into the page pools, in place. ``phys_rows``: (K, C) int64 map
    from each request's logical row (C = the family's per-slot capacity,
    s_max or the ring width) to a flattened pool row (page * page_size +
    offset); entries >= num_pages * page_size (rows past the request's
    reservation, or below a prefix write floor) are dropped. Per-slot
    leaves and "pos" splice as in the dense path; "block_tables" belongs
    to the engine and "ring_iota" is a constant. Returns ``cache``."""
    for key, leaf in cache.items():
        if key in ("block_tables", "ring_iota"):
            continue
        req = request_cache[key]
        if key in PAGED_POOL_LEAVES:
            Lr, P, ps = leaf.shape[:3]
            flat = leaf.view((Lr, P * ps) + tuple(leaf.shape[3:]))
            C = phys_rows.shape[1]
            keep = (phys_rows >= 0) & (phys_rows < P * ps)
            flat[:, phys_rows[keep]] = req[:, :, :C][:, keep].to(leaf.dtype)
        elif key == "pos":
            leaf[slots] = req.to(leaf.dtype)
        else:
            leaf[:, slots] = req.to(leaf.dtype)
    return cache


def seed_prefix_cache(model: Model, cache, phys_rows, row_ok, pos,
                      s_max: int, dtype=torch.float32):
    """A dense batch-K transient prefill cache whose leading rows are
    GATHERED from a paged cache's pools: a prefix-cache hit on the
    transient path starts from the cached prefix and runs only the tail.
    ``phys_rows``: (K, s_max) int64 flattened pool rows; ``row_ok`` masks
    the rows past the cached prefix (zeros, as in a fresh cache, and
    causally invisible to the tail); ``pos``: the position the tail starts
    at."""
    K = phys_rows.shape[0]
    out = model.init_cache(K, s_max, dtype, device=cache["k"].device)
    idx = torch.where(row_ok, phys_rows, 0)
    for key in _pool_keys(out):
        pool = cache[key]                   # (L, P, ps, KV, hd)
        Lr, P, ps = pool.shape[:3]
        rows = pool.view((Lr, P * ps) + tuple(pool.shape[3:]))[:, idx]
        out[key] = torch.where(row_ok[None, :, :, None, None], rows,
                               0.0).to(out[key].dtype)
    out["pos"] = torch.tensor(int(pos), dtype=torch.int32,
                              device=cache["k"].device)
    return out


def cache_capacity(cfg: ArchConfig, s_max: int) -> int:
    """Per-slot sequence capacity of the attention cache: the hybrid family
    keeps a ring of min(window, s_max) rows, every other family s_max; the
    rows the page allocator must cover for one slot."""
    if cfg.family == Family.HYBRID:
        return min(cfg.window, s_max)
    return s_max


def init_paged_cache(model: Model, batch: int, s_max: int, *, page_size: int,
                     num_pages: int, dtype=torch.float32, device=None):
    """Paged serving cache: page pools (L, num_pages, page_size, KV, hd)
    shaped after the dense cache (and, for the hybrid ring, a (L,
    num_pages, page_size) "slot_pos" pool of -1), all-(-1) block tables and
    every slot at INACTIVE_POS. Other leaves (the SSM state and conv carry)
    keep the dense per-slot layout; a hybrid cache also carries a (W,)
    "ring_iota" leaf whose length is the ring width. s_max must be a
    page_size multiple. The SSM family has nothing to page and raises."""
    if model.cfg.family == Family.SSM:
        raise ValueError("rwkv/ssm caches are O(1) in s_max; use init_cache")
    if s_max % page_size:
        raise ValueError(f"s_max {s_max} must be a multiple of page_size "
                         f"{page_size} (paged view == dense view)")
    dense = model.init_cache(batch, s_max, dtype, device="meta")
    out = {}
    for key, leaf in dense.items():
        if key in ("k", "v"):               # (L, B, S, KV, hd) -> pool
            Lr, _, _, KV, hd = leaf.shape
            out[key] = torch.zeros((Lr, num_pages, page_size, KV, hd),
                                   dtype=dtype, device=device)
        elif key == "slot_pos":             # hybrid ring positions -> pool
            out[key] = torch.full((leaf.shape[0], num_pages, page_size), -1,
                                  dtype=torch.int32, device=device)
        elif key != "pos":
            out[key] = torch.zeros(leaf.shape, dtype=leaf.dtype,
                                   device=device)
    out["pos"] = torch.full((batch,), INACTIVE_POS, dtype=torch.int32,
                            device=device)
    out["block_tables"] = torch.full((batch, s_max // page_size), -1,
                                     dtype=torch.int32, device=device)
    if model.cfg.family == Family.HYBRID:
        out["ring_iota"] = torch.arange(cache_capacity(model.cfg, s_max),
                                        dtype=torch.int32, device=device)
    return out


def _pool_keys(cache):
    """The K/V leaves a cache holds: ("k", "v"), or ("k",) for MLA."""
    return tuple(key for key in ("k", "v") if key in cache)


def copy_pool_rows(cache, src_rows, dst_rows):
    """Copy K/V rows between flattened pool positions IN PLACE — the
    copy-on-write materialisation of a partial prefix page. src_rows /
    dst_rows: (K, R) int64 flattened pool rows (page * page_size + offset);
    entries with dst >= num_pages * page_size are dropped. Returns
    ``cache``."""
    for key in _pool_keys(cache):
        pool = cache[key]                   # (L, P, ps, KV, hd)
        Lr, P, ps = pool.shape[:3]
        flat = pool.view((Lr, P * ps) + tuple(pool.shape[3:]))
        keep = dst_rows < P * ps
        src = src_rows[keep].clamp(0, P * ps - 1)
        flat[:, dst_rows[keep]] = flat[:, src]
    return cache


def reduced_config(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Smoke-test-sized config of the same family (identical to
    ``repro.models.registry.reduced_config``)."""
    defaults = dict(
        num_layers=2 if not cfg.cross_attn_every else cfg.cross_attn_every,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, 4 * cfg.num_kv_heads // max(cfg.num_heads, 1)),
        d_ff=128, vocab_size=512, head_dim=16,
        encoder_layers=2 if cfg.encoder_layers else 0,
        num_image_tokens=8 if cfg.cross_attn_every else 0,
        window=8 if cfg.window else 0,
        ssm_state=cfg.ssm_state and 4,
        kv_lora_rank=8 if cfg.kv_lora_rank else 0,
        qk_rope_head_dim=2 if cfg.qk_rope_head_dim else 0,
    )
    if cfg.moe:
        defaults["moe"] = MoEConfig(num_experts=4, top_k=2,
                                    capacity_factor=cfg.moe.capacity_factor)
    if cfg.cross_attn_every:
        defaults["num_layers"] = 2 * cfg.cross_attn_every
    defaults.update(overrides)
    return dataclasses.replace(cfg, **defaults)
