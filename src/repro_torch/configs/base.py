"""Architecture config dataclasses, copied from ``repro.configs.base`` so the
port never imports the JAX package. Field names, defaults and the derived
quantities (``head_dim``, ``padded_vocab``, parameter counts) and the four
input shapes (``ShapeConfig``) are kept
identical: a config built here describes the same network as its ``repro``
twin, which is what lets the equivalence tests bridge weights between them.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    ENCDEC = "encdec"  # [audio] whisper
    SSM = "ssm"        # rwkv6
    HYBRID = "hybrid"  # hymba
    VLM = "vlm"        # llama-3.2-vision
    CNN = "cnn"        # resnet20 (the paper's own model)


class MemoryStrategy(str, enum.Enum):
    """The paper's optimization ladder (§4.1-4.4), the rungs the capacity
    planner (``core/strategies.py``) maps onto planner configurations."""

    BASELINE = "baseline"                # small local budget, no overlap credit
    DUAL_CLOCK = "dual_clock"            # + movement/compute overlap (double buffering)
    ULTRA_RAM = "ultra_ram"              # + large local budget (fewer partitions)
    COMPILER_LARGE_LOCAL = "compiler_large_local"  # + whole-layer residency planning


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (seq_len x global_batch)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                       LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int          # query heads (0 for attn-free)
    num_kv_heads: int       # GQA kv heads
    d_ff: int
    vocab_size: int
    head_dim: int = 0       # 0 => d_model // num_heads
    qkv_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"   # rmsnorm | layernorm
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
    # MLA (multi-head latent attention): >0 => cache a per-token
    # kv_lora_rank-dim latent + a qk_rope_head_dim decoupled RoPE head
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    # hybrid / ssm
    ssm_state: int = 0
    window: int = 0              # sliding-window size (0 = full attention)
    # enc-dec
    encoder_layers: int = 0      # >0 => enc-dec; num_layers is decoder depth
    # vlm
    cross_attn_every: int = 0    # >0 => cross-attn image layers every N layers
    num_image_tokens: int = 0
    skip_shapes: Tuple[str, ...] = ()
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding/unembedding tables are padded to a 512 multiple; logits
        beyond vocab_size are masked (layers.lm_logits)."""
        return ((self.vocab_size + 511) // 512) * 512

    def _attn_params(self) -> int:
        if self.num_heads == 0:
            return 0
        hd = self.head_dim
        if self.kv_lora_rank:
            c, r = self.kv_lora_rank, self.qk_rope_head_dim
            q = self.d_model * self.num_heads * (hd + r)
            kv_a = self.d_model * (c + r) + c
            kv_b = c * self.num_heads * 2 * hd
            o = self.num_heads * hd * self.d_model
            return q + kv_a + kv_b + o
        q = self.d_model * self.num_heads * hd
        kv = 2 * self.d_model * self.num_kv_heads * hd
        o = self.num_heads * hd * self.d_model
        b = (self.num_heads * hd + 2 * self.num_kv_heads * hd) if self.qkv_bias else 0
        return q + kv + o + b

    def _ffn_params(self, gated: bool = True) -> int:
        return (3 if gated else 2) * self.d_model * self.d_ff

    def layer_params(self) -> int:
        """Params of one decoder layer (dense part + routed experts)."""
        p = self._attn_params() + 2 * self.d_model
        if self.moe:
            p += (self.moe.num_experts * self._ffn_params()
                  + self.d_model * self.moe.num_experts)
        else:
            p += self._ffn_params()
        if self.family == Family.SSM:
            p = (6 * self.d_model * self.d_model + 2 * self.d_model * self.d_ff
                 + 2 * self.d_model)
        if self.family == Family.HYBRID:
            p += 2 * self.d_model * self.d_model
        return p

    def total_params(self) -> int:
        emb = self.vocab_size * self.d_model
        unemb = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        layers = self.num_layers * self.layer_params()
        if self.encoder_layers:
            enc = self.encoder_layers * (self._attn_params()
                                         + self._ffn_params(gated=False)
                                         + 2 * self.d_model)
            layers += self.num_layers * self._attn_params() + enc
        if self.cross_attn_every:
            layers += (self.num_layers // self.cross_attn_every
                       * self._attn_params())
        return emb + unemb + layers + self.d_model

    def active_params(self) -> int:
        """Activated params per token (= total for dense; routed top-k for
        MoE)."""
        if not self.moe:
            return self.total_params()
        dense_layer = (self._attn_params() + 2 * self.d_model
                       + self.d_model * self.moe.num_experts)
        active_ffn = self.moe.top_k * self._ffn_params()
        layers = self.num_layers * (dense_layer + active_ffn)
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings
                                                else 2)
        return emb + layers + self.d_model
