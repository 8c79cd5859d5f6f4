"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H d_ff=13440 vocab=92416.

qwen1.5 architecture [hf:Qwen/CodeQwen1.5-7B]: QKV bias, rope_theta=1e6,
SwiGLU + RMSNorm — the numbers of ``repro.configs.codeqwen1_5_7b``.
"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13_440, vocab_size=92_416,
    qkv_bias=True, rope_theta=1e6,
)
