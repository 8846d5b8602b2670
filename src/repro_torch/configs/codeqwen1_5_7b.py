"""codeqwen1.5-7b — qwen1.5 arch, QKV bias. [hf:Qwen/CodeQwen1.5-7B; hf]"""
from repro_torch.configs.base import ArchConfig, Family

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family=Family.DENSE,
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13440, vocab_size=92416,
    qkv_bias=True,
    skip_shapes=("long_500k",),
    notes="full attention => skip long_500k",
)
