"""qwen2-1.5b [dense]: 28L d_model=1536 12H (kv=2) d_ff=8960 vocab=151936.

GQA with QKV bias [arXiv:2407.10671]; head_dim 128, tied embeddings,
rope_theta=1e6 — the numbers of ``repro.configs.qwen2_1_5b``.
"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151_936, head_dim=128,
    qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
)
