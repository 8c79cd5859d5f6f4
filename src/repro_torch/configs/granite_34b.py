"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch code model [arXiv:2405.04324]; the numbers of
``repro.configs.granite_34b``.  MQA: all 48 query heads read one KV head.
"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24_576, vocab_size=49_152, head_dim=128,
)
