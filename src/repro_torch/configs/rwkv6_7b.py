"""rwkv6-7b (Finch) — attention-free, data-dependent decay. [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ArchConfig, Family

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family=Family.SSM,
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    d_ff=14336, vocab_size=65536,
    head_dim=64, ssm_state=64,
    notes="attn-free: num_heads used as RWKV time-mix heads (head_dim=64); "
          "O(1) decode state; long_500k runs",
)
