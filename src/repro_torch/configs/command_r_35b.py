"""command-r-35b — dense GQA, no biases. [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import ArchConfig, Family

CONFIG = ArchConfig(
    name="command-r-35b",
    family=Family.DENSE,
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256000,
    norm="layernorm",
    skip_shapes=("long_500k",),
    notes="cohere-style parallel-ish block approximated as sequential; no-bias; "
          "full attention => skip long_500k",
)
