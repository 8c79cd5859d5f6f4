"""Blocks: spec / train / prefill / decode of each block kind, the twins
of ``repro.models.blocks``.

Kinds: "attn" (GQA + MLP or MoE, optional cross-attention: whisper's
decoder), "mla" (DeepSeek latent attention + MLP or MoE), "mamba"
(Mamba2, no FFN), "mlstm" / "slstm" (xLSTM, no FFN: their projections
live in the cell).  Every kind exposes

  *_spec(arch)                 -> ParamSpec tree of ONE layer
  *_train(p, arch, x, ...)     -> (x, aux_loss)
  *_prefill(p, arch, x, ...)   -> (x, aux, cache_entry)
  *_decode(p, arch, x, cache_entry, pos, ...) -> (x, new_cache_entry)

``aux_loss`` is MoE's load-balance loss (a 0-d tensor) and 0.0 for the
blocks without one.  An attention block's ``window`` is this layer's
window (None or 0 = global); ``enc_kv`` the layer's cross-attention k/v
of the encoder output (``attention.cross_kv``).  Norms are RMSNorm or
layernorm (``arch.norm_kind``), the MLP SwiGLU or GELU
(``arch.mlp_kind``).
"""
from __future__ import annotations

from repro_torch.models import attention as att
from repro_torch.models import mamba2 as m2
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xl
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


def mla_cfg(arch) -> mla_mod.MLAConfig:
    return mla_mod.MLAConfig(
        d_model=arch.d_model, n_heads=arch.n_heads,
        kv_lora_rank=arch.kv_lora_rank, q_lora_rank=arch.q_lora_rank,
        rope_theta=arch.rope_theta, chunk_q=arch.attn_chunk_q)


def mamba_cfg(arch) -> m2.Mamba2Config:
    return m2.Mamba2Config(d_model=arch.d_model, d_state=arch.ssm_state,
                           chunk=arch.mamba_chunk)


def moe_cfg(arch) -> moe_mod.MoEConfig:
    return moe_mod.MoEConfig(
        d_model=arch.d_model, n_experts=arch.moe_experts,
        top_k=arch.moe_top_k, d_ff_expert=arch.d_ff,
        n_shared=arch.moe_shared, capacity_factor=arch.moe_capacity)


def _mlp_spec(arch, d_ff=None):
    d_ff = d_ff or arch.d_ff
    if arch.mlp_kind == "gelu":
        return gelu_mlp_spec(arch.d_model, d_ff)
    return swiglu_spec(arch.d_model, d_ff)


def _mlp(arch, p, x):
    return gelu_mlp(p, x) if arch.mlp_kind == "gelu" else swiglu(p, x)


def _ffn_spec(arch, moe, d_ff):
    return moe_mod.moe_spec(moe_cfg(arch)) if moe else _mlp_spec(arch, d_ff)


def _ffn_apply(p, arch, x, moe):
    """(h, aux): the block's FFN of the normed x, MoE or dense."""
    if moe:
        return moe_mod.moe_forward(p["ffn"], moe_cfg(arch), x)
    return _mlp(arch, p["ffn"], x), 0.0


# ---------------------------------------------------------------------------
# attention block (GQA; optional MoE ffn; optional cross-attention)
# ---------------------------------------------------------------------------

def attn_block_spec(arch, moe=False, cross=False, d_ff=None):
    spec = {
        "norm1": _norm_spec(arch),
        "attn": att.attn_spec(attn_cfg(arch)),
        "norm2": _norm_spec(arch),
        "ffn": _ffn_spec(arch, moe, d_ff),
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


def attn_block_train(p, arch, x, window=None, moe=False, enc_kv=None,
                     causal=True):
    cfg = attn_cfg(arch, causal)
    x = x + att.attn_forward(p["attn"], cfg, _norm(arch, p["norm1"], x),
                             window=window)
    x = _cross(p, arch, cfg, x, enc_kv)
    h, aux = _ffn_apply(p, arch, _norm(arch, p["norm2"], x), moe)
    return x + h, aux


def attn_block_prefill(p, arch, x, cache_len, window=None, moe=False,
                       enc_kv=None):
    cfg = attn_cfg(arch)
    y, kv = att.attn_prefill(p["attn"], cfg, _norm(arch, p["norm1"], x),
                             cache_len, window=window)
    x = _cross(p, arch, cfg, x + y, enc_kv)
    h, aux = _ffn_apply(p, arch, _norm(arch, p["norm2"], x), moe)
    return x + h, aux, kv


def attn_block_decode(p, arch, x, cache, pos, window=None, moe=False,
                      enc_kv=None):
    cfg = attn_cfg(arch)
    ck, cv = cache
    y, ck, cv = att.attn_decode(p["attn"], cfg, _norm(arch, p["norm1"], x),
                                ck, cv, pos, window=window)
    x = _cross(p, arch, cfg, x + y, enc_kv)
    h, _ = _ffn_apply(p, arch, _norm(arch, p["norm2"], x), moe)
    return x + h, (ck, cv)


# ---------------------------------------------------------------------------
# MLA block (DeepSeek)
# ---------------------------------------------------------------------------

def mla_block_spec(arch, moe=False, d_ff=None):
    return {
        "norm1": _norm_spec(arch),
        "attn": mla_mod.mla_spec(mla_cfg(arch)),
        "norm2": _norm_spec(arch),
        "ffn": _ffn_spec(arch, moe, d_ff),
    }


def mla_block_train(p, arch, x, moe=False):
    x = x + mla_mod.mla_forward(p["attn"], mla_cfg(arch),
                                _norm(arch, p["norm1"], x))
    h, aux = _ffn_apply(p, arch, _norm(arch, p["norm2"], x), moe)
    return x + h, aux


def mla_block_prefill(p, arch, x, cache_len, moe=False):
    y, cache = mla_mod.mla_prefill(p["attn"], mla_cfg(arch),
                                   _norm(arch, p["norm1"], x), cache_len)
    x = x + y
    h, aux = _ffn_apply(p, arch, _norm(arch, p["norm2"], x), moe)
    return x + h, aux, cache


def mla_block_decode(p, arch, x, cache, pos, moe=False):
    y, cache = mla_mod.mla_decode(p["attn"], mla_cfg(arch),
                                  _norm(arch, p["norm1"], x), cache, pos)
    x = x + y
    h, _ = _ffn_apply(p, arch, _norm(arch, p["norm2"], x), moe)
    return x + h, cache


# ---------------------------------------------------------------------------
# mamba / xlstm blocks (pre-norm cell, residual, no FFN)
# ---------------------------------------------------------------------------

def mamba_block_spec(arch):
    return {"norm": _norm_spec(arch),
            "cell": m2.mamba2_spec(mamba_cfg(arch))}


def mamba_block_train(p, arch, x):
    return x + m2.mamba2_forward(p["cell"], mamba_cfg(arch),
                                 _norm(arch, p["norm"], x)), 0.0


def mamba_block_prefill(p, arch, x):
    y, state = m2.mamba2_forward(p["cell"], mamba_cfg(arch),
                                 _norm(arch, p["norm"], x), return_state=True)
    return x + y, 0.0, state


def mamba_block_decode(p, arch, x, state, pos):
    y, state = m2.mamba2_decode(p["cell"], mamba_cfg(arch),
                                _norm(arch, p["norm"], x), state)
    return x + y, state


def _mlstm_cfg(arch):
    return xl.MLSTMConfig(d_model=arch.d_model, n_heads=arch.n_heads)


def mlstm_block_spec(arch):
    return {"norm": _norm_spec(arch),
            "cell": xl.mlstm_spec(_mlstm_cfg(arch))}


def mlstm_block_train(p, arch, x):
    return x + xl.mlstm_forward(p["cell"], _mlstm_cfg(arch),
                                _norm(arch, p["norm"], x)), 0.0


def mlstm_block_prefill(p, arch, x):
    y, state = xl.mlstm_forward(p["cell"], _mlstm_cfg(arch),
                                _norm(arch, p["norm"], x), return_state=True)
    return x + y, 0.0, state


def mlstm_block_decode(p, arch, x, state, pos):
    y, state = xl.mlstm_decode(p["cell"], _mlstm_cfg(arch),
                               _norm(arch, p["norm"], x), state)
    return x + y, state


def _slstm_cfg(arch):
    return xl.SLSTMConfig(d_model=arch.d_model, n_heads=arch.n_heads)


def slstm_block_spec(arch):
    return {"norm": _norm_spec(arch),
            "cell": xl.slstm_spec(_slstm_cfg(arch))}


def slstm_block_train(p, arch, x):
    return x + xl.slstm_forward(p["cell"], _slstm_cfg(arch),
                                _norm(arch, p["norm"], x)), 0.0


def slstm_block_prefill(p, arch, x):
    y, state = xl.slstm_forward(p["cell"], _slstm_cfg(arch),
                                _norm(arch, p["norm"], x), return_state=True)
    return x + y, 0.0, state


def slstm_block_decode(p, arch, x, state, pos):
    y, state = xl.slstm_decode(p["cell"], _slstm_cfg(arch),
                               _norm(arch, p["norm"], x), state)
    return x + y, state
