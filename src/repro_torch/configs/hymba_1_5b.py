"""hymba-1.5b — hybrid: parallel attention + mamba heads per layer, ssm_state=16.
Attention heads use sliding-window (1024) => sub-quadratic => long_500k RUNS.
[arXiv:2411.13676; hf]"""
from repro_torch.configs.base import ArchConfig, Family

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family=Family.HYBRID,
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001,
    head_dim=64, ssm_state=16, window=1024,
    notes="parallel attn+mamba heads; windowed attention => long_500k runs",
)
