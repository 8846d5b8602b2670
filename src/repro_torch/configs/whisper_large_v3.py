"""whisper-large-v3 — encoder-decoder audio transformer; conv frontend is a STUB
(input_specs() provides precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig, Family

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family=Family.ENCDEC,
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866,
    encoder_layers=32,
    norm="layernorm", qkv_bias=True, mlp_bias=True,
    skip_shapes=("long_500k",),
    notes="enc-dec; decode shapes exercise the DECODER (self-attn KV cache + cross-attn "
          "to encoder states); full attention => skip long_500k",
)
