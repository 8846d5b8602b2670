"""minicpm-2b — dense llama-like arch, WSD schedule. [arXiv:2404.06395; hf]"""
from repro_torch.configs.base import ArchConfig, Family

CONFIG = ArchConfig(
    name="minicpm-2b",
    family=Family.DENSE,
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
    notes="WSD (warmup-stable-decay) schedule wired in optim/schedules.py; "
          "full attention => skip long_500k",
)
