"""gemma3-27b [dense]: 62L d_model=5376 32H (kv=16) d_ff=21504 vocab=262144.

5:1 local:global attention (window 1024, every 6th layer global), head_dim
128, qk-norm, sqrt(d) embedding scale, tied embeddings
[hf:google/gemma-3-*] — the numbers of ``repro.configs.gemma3_27b``.
"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_ff=21_504, vocab_size=262_144, head_dim=128,
    qk_norm=True, window=1024, global_every=6,
    embed_scale=True, tie_embeddings=True, rope_theta=1e6,
)
