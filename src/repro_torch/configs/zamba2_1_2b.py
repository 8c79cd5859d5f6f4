"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H d_ff=8192 vocab=32000,
ssm_state=64 — the numbers of ``repro.configs.zamba2_1_2b``.

Mamba2 blocks plus one SHARED attention block applied before every 6
Mamba layers (the same parameters at each application, its output delta
re-projected) [arXiv:2411.15242].  The Mamba state is O(1) per token, so
it takes the long_500k shape.
"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32_000,
    block_pattern="zamba", shared_attn_every=6, ssm_state=64,
    sub_quadratic=True,
)
