"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H d_ff=8192 vocab=32064.

phi3-mini backbone + CLIP frontend [hf:microsoft/Phi-3-vision-128k-instruct]
— the numbers of ``repro.configs.phi3_vision_4_2b``.  CLIP is a stub:
callers hand in (B, 576, 1024) patch embeddings, which are projected and
prepended to the token stream.  head_dim is 3072 / 32 = 96.
"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32_064,
    vision_tokens=576, d_frontend=1024,
)
