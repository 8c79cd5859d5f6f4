"""Transformer blocks: spec / train / prefill / decode of the "attn" kind,
the twins of ``repro.models.blocks`` for dense attention models, with
optional cross-attention (whisper's decoder).

  attn_block_spec(arch, cross=False)            -> ParamSpec tree of ONE layer
  attn_block_train(p, arch, x, window, enc_kv, causal) -> (x, aux_loss)
  attn_block_prefill(p, arch, x, cache_len, window, enc_kv) -> (x, aux, (k, v))
  attn_block_decode(p, arch, x, (k, v), pos, window, enc_kv) -> (x, (k, v))

``window`` is this layer's window (None or 0 = global); ``enc_kv`` the
layer's cross-attention k/v of the encoder output (``attention.cross_kv``).
Norms are RMSNorm or layernorm (``arch.norm_kind``), the MLP SwiGLU or
GELU (``arch.mlp_kind``).  MoE and the MLA / Mamba / xLSTM kinds are not
ported yet (ROADMAP queue 1 #8): asking for them raises
``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.models import attention as att
from repro_torch.models.layers import (
    gelu_mlp,
    gelu_mlp_spec,
    layernorm,
    layernorm_spec,
    rmsnorm,
    rmsnorm_spec,
    swiglu,
    swiglu_spec,
)

_LATER = "not ported yet (ROADMAP queue 1 #8)"


def _norm_spec(arch, d=None):
    d = d or arch.d_model
    return layernorm_spec(d) if arch.norm_kind == "layernorm" \
        else rmsnorm_spec(d)


def _norm(arch, p, x):
    return layernorm(p, x) if arch.norm_kind == "layernorm" else rmsnorm(p, x)


def attn_cfg(arch, causal=True) -> att.AttnConfig:
    return att.AttnConfig(
        d_model=arch.d_model, n_heads=arch.n_heads,
        n_kv_heads=arch.n_kv_heads, head_dim=arch.head_dim_v,
        qkv_bias=arch.qkv_bias, qk_norm=arch.qk_norm, causal=causal,
        window=None, rope_theta=arch.rope_theta, use_rope=arch.use_rope,
        chunk_q=arch.attn_chunk_q, use_flash=arch.use_flash_attention)


def _mlp_spec(arch, d_ff=None):
    d_ff = d_ff or arch.d_ff
    if arch.mlp_kind == "gelu":
        return gelu_mlp_spec(arch.d_model, d_ff)
    return swiglu_spec(arch.d_model, d_ff)


def _mlp(arch, p, x):
    return gelu_mlp(p, x) if arch.mlp_kind == "gelu" else swiglu(p, x)


def attn_block_spec(arch, moe=False, cross=False, d_ff=None):
    if moe:
        raise NotImplementedError(f"MoE blocks are {_LATER}")
    spec = {
        "norm1": _norm_spec(arch),
        "attn": att.attn_spec(attn_cfg(arch)),
        "norm2": _norm_spec(arch),
        "ffn": _mlp_spec(arch, d_ff),
    }
    if cross:
        spec["norm_x"] = _norm_spec(arch)
        spec["xattn"] = att.cross_attn_spec(attn_cfg(arch, causal=False))
    return spec


def _cross(p, arch, cfg, x, enc_kv):
    if enc_kv is None:
        return x
    return x + att.cross_attn(p["xattn"], cfg, _norm(arch, p["norm_x"], x),
                              enc_kv)


def attn_block_train(p, arch, x, window=None, enc_kv=None, causal=True):
    cfg = attn_cfg(arch, causal)
    x = x + att.attn_forward(p["attn"], cfg, _norm(arch, p["norm1"], x),
                             window=window)
    x = _cross(p, arch, cfg, x, enc_kv)
    h = _mlp(arch, p["ffn"], _norm(arch, p["norm2"], x))
    return x + h, 0.0


def attn_block_prefill(p, arch, x, cache_len, window=None, enc_kv=None):
    cfg = attn_cfg(arch)
    y, kv = att.attn_prefill(p["attn"], cfg, _norm(arch, p["norm1"], x),
                             cache_len, window=window)
    x = _cross(p, arch, cfg, x + y, enc_kv)
    h = _mlp(arch, p["ffn"], _norm(arch, p["norm2"], x))
    return x + h, 0.0, kv


def attn_block_decode(p, arch, x, cache, pos, window=None, enc_kv=None):
    cfg = attn_cfg(arch)
    ck, cv = cache
    y, ck, cv = att.attn_decode(p["attn"], cfg, _norm(arch, p["norm1"], x),
                                ck, cv, pos, window=window)
    x = _cross(p, arch, cfg, x + y, enc_kv)
    h = _mlp(arch, p["ffn"], _norm(arch, p["norm2"], x))
    return x + h, (ck, cv)
