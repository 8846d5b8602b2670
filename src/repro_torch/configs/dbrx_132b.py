"""dbrx-132b — 16 experts top-4, fine-grained MoE.
[hf:databricks/dbrx-base; unverified]"""
from repro_torch.configs.base import ArchConfig, Family, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family=Family.MOE,
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    moe=MoEConfig(num_experts=16, top_k=4),
    skip_shapes=("long_500k",),
    notes="GQA kv=8; full attention => skip long_500k",
)
