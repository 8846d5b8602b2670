"""qwen2.5-32b — dense GQA kv=8, QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ArchConfig, Family

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family=Family.DENSE,
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=27648, vocab_size=152064,
    qkv_bias=True,
    skip_shapes=("long_500k",),
    notes="hillclimb target (decode_32k); full attention => skip long_500k",
)
