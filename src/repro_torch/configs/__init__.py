"""Architecture registry of the port (``--arch <id>``): the reference's
ten architectures in its order — the xLSTM ``xlstm-125m``, the
encoder-decoder ``whisper-medium``, the vision model
``phi-3-vision-4.2b``, the dense ``codeqwen1.5-7b``, ``gemma3-27b``,
``granite-34b`` and ``qwen2-1.5b``, the MoE + MLA ``deepseek-v3-671b``
and ``deepseek-v2-236b`` and the Mamba2 hybrid ``zamba2-1.2b``.
``reduced()`` builds the same small variant as ``repro.configs.reduced``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    codeqwen1_5_7b,
    deepseek_v2_236b,
    deepseek_v3_671b,
    gemma3_27b,
    granite_34b,
    phi3_vision_4_2b,
    qwen2_1_5b,
    whisper_medium,
    xlstm_125m,
    zamba2_1_2b,
)
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable, skip_reason
from repro_torch.models.lm import ArchConfig

_MODULES = [
    xlstm_125m, whisper_medium, phi3_vision_4_2b, codeqwen1_5_7b,
    gemma3_27b, granite_34b, qwen2_1_5b, deepseek_v3_671b,
    deepseek_v2_236b, zamba2_1_2b,
]

REGISTRY: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCH_NAMES = list(REGISTRY)


def get_arch(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    return REGISTRY[name]


def reduced(arch: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU tests, with the reference's
    numbers (4 layers, d_model 64, 4 heads, head_dim 16, vocab 256,
    query chunks of 16, Mamba chunks of 8; window 8; 8 experts, top-2,
    at most one shared and one leading dense layer (d_ff 64); MLA's
    kv_lora 32 and q_lora 48; zamba's shared block every 2 layers over a
    state of 16; an sLSTM every 2nd layer; 2 encoder layers over 8
    frames; 4 image tokens of width 32).  The structure is kept: MoE
    stays MoE, zamba keeps its shared-block cadence, xLSTM its sLSTM
    interleave."""
    kw: dict = dict(
        n_layers=min(arch.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(arch.n_kv_heads, 4) if arch.n_kv_heads > 1 else 1,
        d_ff=128 if arch.d_ff else 0,
        vocab_size=256,
        head_dim=16,
        attn_chunk_q=16,
        mamba_chunk=8,
        loss_chunk=16,
        remat=False,
    )
    if arch.moe_experts:
        kw.update(moe_experts=8, moe_top_k=2,
                  moe_shared=min(arch.moe_shared, 1),
                  moe_dense_layers=min(arch.moe_dense_layers, 1),
                  moe_d_ff_dense=64 if arch.moe_d_ff_dense else 0)
    if arch.use_mla:
        kw.update(kv_lora_rank=32, q_lora_rank=48 if arch.q_lora_rank else 0)
    if arch.window:
        kw.update(window=8, global_every=arch.global_every)
    if arch.block_pattern == "zamba":
        kw.update(shared_attn_every=2, ssm_state=16)
    if arch.block_pattern == "xlstm":
        kw.update(slstm_every=2)
    if arch.enc_dec:
        kw.update(n_enc_layers=2, n_frames=8)
    if arch.vision_tokens:
        kw.update(vision_tokens=4, d_frontend=32)
    return dataclasses.replace(arch, **kw)
