"""Model facade and the paged serving cache, as in
``repro/models/registry.py``. The port serves the dense family; every other
family raises ``NotImplementedError`` naming its ROADMAP item.

Paged cache convention (shared with ``repro``): the K/V leaves are shared
page pools (L, num_pages, page_size, KV, hd) with no batch axis, addressed
through a "block_tables" leaf (B, max_pages_per_slot) int32 (-1 =
unallocated), and "pos" is a (B,) int32 per-slot position vector that
starts at ``layers.INACTIVE_POS`` for every slot.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models import transformer
from repro_torch.models.layers import INACTIVE_POS


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    mod: Any

    def init(self, gen: torch.Generator, device):
        return self.mod.init(self.cfg, gen, device)

    def init_cache(self, batch: int, s_max: int, dtype=torch.float32,
                   device=None):
        return self.mod.init_cache(self.cfg, batch, s_max, dtype, device)

    def decode_step(self, params, token, cache, **kw):
        return self.mod.decode_step(params, self.cfg, token, cache, **kw)

    def prefill_chunk_paged(self, params, tokens, cache, **kw):
        return self.mod.prefill_chunk_paged(params, self.cfg, tokens, cache,
                                            **kw)


def get_model(cfg: ArchConfig) -> Model:
    transformer._check_supported(cfg)
    return Model(cfg=cfg, mod=transformer)


def cache_capacity(cfg: ArchConfig, s_max: int) -> int:
    """Per-slot sequence capacity of the attention cache: s_max rows for
    the dense family (the hybrid ring's narrower width is not ported)."""
    return s_max


def init_paged_cache(model: Model, batch: int, s_max: int, *, page_size: int,
                     num_pages: int, dtype=torch.float32, device=None):
    """Paged serving cache: page pools (L, num_pages, page_size, KV, hd)
    shaped after the dense cache, all-(-1) block tables and every slot at
    INACTIVE_POS. s_max must be a page_size multiple."""
    if s_max % page_size:
        raise ValueError(f"s_max {s_max} must be a multiple of page_size "
                         f"{page_size} (paged view == dense view)")
    dense = model.init_cache(batch, s_max, dtype, device="meta")
    Lr, _, _, KV, hd = dense["k"].shape
    pool = (Lr, num_pages, page_size, KV, hd)
    return {"k": torch.zeros(pool, dtype=dtype, device=device),
            "v": torch.zeros(pool, dtype=dtype, device=device),
            "pos": torch.full((batch,), INACTIVE_POS, dtype=torch.int32,
                              device=device),
            "block_tables": torch.full((batch, s_max // page_size), -1,
                                       dtype=torch.int32, device=device)}


def copy_pool_rows(cache, src_rows, dst_rows):
    """Copy K/V rows between flattened pool positions IN PLACE — the
    copy-on-write materialisation of a partial prefix page. src_rows /
    dst_rows: (K, R) int64 flattened pool rows (page * page_size + offset);
    entries with dst >= num_pages * page_size are dropped. Returns
    ``cache``."""
    for key in ("k", "v"):
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
