"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536 (expert)
vocab=102400 — the numbers of ``repro.configs.deepseek_v2_236b``.

MoE with 2 shared + 160 routed experts, top-6; MLA with kv_lora 512 and
q_lora 1536; the first layer dense (d_ff 12288) [arXiv:2405.04434].
"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab_size=102_400,
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
    moe_experts=160, moe_top_k=6, moe_shared=2,
    moe_dense_layers=1, moe_d_ff_dense=12_288,
)
