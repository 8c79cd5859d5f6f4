"""Architecture registry of the port (``--arch <id>``).

Only the dense GQA model ``qwen2-1.5b`` is ported; the reference's other
nine architectures wait for their blocks (ROADMAP queue 1 #8).
``reduced()`` builds the same small variant as ``repro.configs.reduced``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import qwen2_1_5b
from repro_torch.models.lm import ArchConfig

REGISTRY: dict[str, ArchConfig] = {qwen2_1_5b.CONFIG.name: qwen2_1_5b.CONFIG}
ARCH_NAMES = list(REGISTRY)


def get_arch(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port has {ARCH_NAMES} "
                       f"(the other architectures: ROADMAP queue 1 #8)")
    return REGISTRY[name]


def reduced(arch: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU tests, with the reference's
    numbers (4 layers, d_model 64, 4 heads, head_dim 16, vocab 256,
    query chunks of 16)."""
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
    return dataclasses.replace(arch, **kw)
