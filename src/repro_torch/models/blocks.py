"""Transformer blocks: spec / train / prefill / decode of the "attn" kind,
the twins of ``repro.models.blocks`` for dense GQA models.

  attn_block_spec(arch)                         -> ParamSpec tree of ONE layer
  attn_block_train(p, arch, x, window)          -> (x, aux_loss)
  attn_block_prefill(p, arch, x, cache_len, window) -> (x, aux, (k, v))
  attn_block_decode(p, arch, x, (k, v), pos, window) -> (x, (k, v))

``window`` is this layer's window (None or 0 = global).  MoE, cross-
attention, layernorm, the GELU MLP and the MLA / Mamba / xLSTM kinds are
not ported yet (ROADMAP queue 1 #8): asking for them raises
``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.models import attention as att
from repro_torch.models.layers import rmsnorm, rmsnorm_spec, swiglu, swiglu_spec

_LATER = "not ported yet (ROADMAP queue 1 #8)"


def _norm_spec(arch):
    if arch.norm_kind != "rmsnorm":
        raise NotImplementedError(f"norm_kind {arch.norm_kind!r} {_LATER}")
    return rmsnorm_spec(arch.d_model)


def _norm(arch, p, x):
    if arch.norm_kind != "rmsnorm":
        raise NotImplementedError(f"norm_kind {arch.norm_kind!r} {_LATER}")
    return rmsnorm(p, x)


def attn_cfg(arch, causal=True) -> att.AttnConfig:
    return att.AttnConfig(
        d_model=arch.d_model, n_heads=arch.n_heads,
        n_kv_heads=arch.n_kv_heads, head_dim=arch.head_dim_v,
        qkv_bias=arch.qkv_bias, qk_norm=arch.qk_norm, causal=causal,
        window=None, rope_theta=arch.rope_theta, use_rope=arch.use_rope,
        chunk_q=arch.attn_chunk_q, use_flash=arch.use_flash_attention)


def _mlp_spec(arch, d_ff=None):
    if arch.mlp_kind != "swiglu":
        raise NotImplementedError(f"mlp_kind {arch.mlp_kind!r} {_LATER}")
    return swiglu_spec(arch.d_model, d_ff or arch.d_ff)


def _mlp(arch, p, x):
    if arch.mlp_kind != "swiglu":
        raise NotImplementedError(f"mlp_kind {arch.mlp_kind!r} {_LATER}")
    return swiglu(p, x)


def attn_block_spec(arch, moe=False, cross=False, d_ff=None):
    if moe or cross:
        raise NotImplementedError(f"MoE and cross-attention blocks are "
                                  f"{_LATER}")
    return {
        "norm1": _norm_spec(arch),
        "attn": att.attn_spec(attn_cfg(arch)),
        "norm2": _norm_spec(arch),
        "ffn": _mlp_spec(arch, d_ff),
    }


def attn_block_train(p, arch, x, window=None, causal=True):
    cfg = attn_cfg(arch, causal)
    x = x + att.attn_forward(p["attn"], cfg, _norm(arch, p["norm1"], x),
                             window=window)
    h = _mlp(arch, p["ffn"], _norm(arch, p["norm2"], x))
    return x + h, 0.0


def attn_block_prefill(p, arch, x, cache_len, window=None):
    cfg = attn_cfg(arch)
    y, kv = att.attn_prefill(p["attn"], cfg, _norm(arch, p["norm1"], x),
                             cache_len, window=window)
    x = x + y
    h = _mlp(arch, p["ffn"], _norm(arch, p["norm2"], x))
    return x + h, 0.0, kv


def attn_block_decode(p, arch, x, cache, pos, window=None):
    cfg = attn_cfg(arch)
    ck, cv = cache
    y, ck, cv = att.attn_decode(p["attn"], cfg, _norm(arch, p["norm1"], x),
                                ck, cv, pos, window=window)
    x = x + y
    h = _mlp(arch, p["ffn"], _norm(arch, p["norm2"], x))
    return x + h, (ck, cv)
