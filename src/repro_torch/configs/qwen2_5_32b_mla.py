"""qwen2.5-32b-mla — the qwen2.5-32b stack with MLA latent KV.

Multi-head latent attention (DeepSeek-V3 style): instead of per-head
K/V the cache stores a per-token ``kv_lora_rank``-dim compressed latent
plus a small ``qk_rope_head_dim`` decoupled RoPE head, and decode folds
``wkv_b`` into the query/output einsums (absorb path) so attention runs
directly over the latent. Resident KV per token per layer drops from
``2 * num_kv_heads * head_dim`` floats to ``kv_lora_rank +
qk_rope_head_dim`` — here 576 vs the GQA parent's 2048 (0.28x).
"""
from repro_torch.configs.base import ArchConfig, Family

CONFIG = ArchConfig(
    name="qwen2.5-32b-mla",
    family=Family.DENSE,
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
    d_ff=27648, vocab_size=152064,
    head_dim=128,
    kv_lora_rank=512, qk_rope_head_dim=64,
    skip_shapes=("long_500k",),
    notes="MLA variant of qwen2.5-32b; latent page rows are c_kv+r=576 floats",
)
