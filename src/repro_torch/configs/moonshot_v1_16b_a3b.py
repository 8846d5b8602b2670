"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.configs.base import ArchConfig, Family, MoEConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family=Family.MOE,
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163840,
    moe=MoEConfig(num_experts=64, top_k=6),
    skip_shapes=("long_500k",),
    notes="fine-grained MoE: per-expert d_ff=1408; full attention => skip long_500k",
)
