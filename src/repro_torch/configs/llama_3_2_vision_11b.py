"""llama-3.2-vision-11b — cross-attn image layers every 5th layer; vision
frontend is a STUB (input_specs() provides patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ArchConfig, Family

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family=Family.VLM,
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    cross_attn_every=5, num_image_tokens=1601,
    skip_shapes=("long_500k",),
    notes="cross-attn every 5th layer to 1601 patch embeddings; "
          "full attention => skip long_500k",
)
