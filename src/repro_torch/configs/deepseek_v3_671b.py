"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048 (expert)
vocab=129280 — the numbers of ``repro.configs.deepseek_v3_671b``.

MoE with 1 shared + 256 routed experts, top-8; MLA with kv_lora 512 and
q_lora 1536; a depth-1 multi-token-prediction head; the first 3 layers
dense (d_ff 18432) [arXiv:2412.19437].
"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab_size=129_280,
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
    moe_experts=256, moe_top_k=8, moe_shared=1,
    moe_dense_layers=3, moe_d_ff_dense=18_432,
    mtp=True,
)
