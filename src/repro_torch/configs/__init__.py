"""Architecture registry of the port (``--arch <id>``).

The dense models (``qwen2-1.5b``, ``codeqwen1.5-7b``, ``gemma3-27b``,
``granite-34b``), the encoder-decoder ``whisper-medium`` and the vision
model ``phi-3-vision-4.2b`` are ported; the reference's other four
(``xlstm-125m``, ``zamba2-1.2b`` and the two deepseek configs) wait for
their blocks (ROADMAP queue 1 #8).  ``reduced()`` builds the same small
variant as ``repro.configs.reduced``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    codeqwen1_5_7b,
    gemma3_27b,
    granite_34b,
    phi3_vision_4_2b,
    qwen2_1_5b,
    whisper_medium,
)
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable, skip_reason
from repro_torch.models.lm import ArchConfig

_MODULES = [whisper_medium, phi3_vision_4_2b, codeqwen1_5_7b, gemma3_27b,
            granite_34b, qwen2_1_5b]

REGISTRY: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCH_NAMES = list(REGISTRY)


def get_arch(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port has {ARCH_NAMES} "
                       f"(the other architectures: ROADMAP queue 1 #8)")
    return REGISTRY[name]


def reduced(arch: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU tests, with the reference's
    numbers (4 layers, d_model 64, 4 heads, head_dim 16, vocab 256,
    query chunks of 16; window 8; 2 encoder layers over 8 frames; 4
    image tokens of width 32)."""
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
    if arch.window:
        kw.update(window=8, global_every=arch.global_every)
    if arch.enc_dec:
        kw.update(n_enc_layers=2, n_frames=8)
    if arch.vision_tokens:
        kw.update(vision_tokens=4, d_frontend=32)
    return dataclasses.replace(arch, **kw)
