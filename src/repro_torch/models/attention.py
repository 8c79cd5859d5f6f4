"""Attention: MHA/GQA/MQA with RoPE, bias, qk-norm and sliding window;
causal, bidirectional and cross variants; full-sequence (prefill) and
single-token (decode) paths — the twins of ``repro.models.attention``.

Full-sequence self-attention goes through the CUDA flash-attention
kernel (``kernels/flash_attention``) when ``use_flash`` is set, the call
passes no per-layer window, the queries are the keys and there are at
least 128 of them — the reference's route condition (whisper's
bidirectional encoder takes it too; cross-attention, whose queries are
not its keys, does not).  Otherwise it takes
the query-chunked plain path, the counterpart of the reference's XLA
path: only a (Cq, Sk) block of scores exists at a time.  Decode
attention is plain PyTorch, as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models.layers import ParamSpec, apply_rope, rmsnorm

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    causal: bool = True
    window: int | None = None          # sliding-window size (None = global)
    rope_theta: float = 10_000.0
    use_rope: bool = True
    chunk_q: int = 512                 # query block for the chunked path
    softmax_scale: float | None = None
    # route full-sequence self-attention through the CUDA flash kernel
    use_flash: bool = False

    @property
    def scale(self) -> float:
        return self.softmax_scale or self.head_dim ** -0.5


def attn_spec(cfg: AttnConfig) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    spec = {
        "wq": ParamSpec((d, hq, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((hq, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamSpec((hq, hd), ("heads", "head_dim"),
                               init="zeros")
        spec["bk"] = ParamSpec((hkv, hd), ("kv_heads", "head_dim"),
                               init="zeros")
        spec["bv"] = ParamSpec((hkv, hd), ("kv_heads", "head_dim"),
                               init="zeros")
    if cfg.qk_norm:
        spec["q_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
        spec["k_norm"] = ParamSpec((hd,), ("head_dim",), init="ones")
    return spec


def _qkv(p, cfg: AttnConfig, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rmsnorm({"scale": p["q_norm"]}, q)
        k = rmsnorm({"scale": p["k_norm"]}, k)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask(cfg: AttnConfig, q_pos, k_pos, window: int | None = None):
    """(Sq, Sk) bool mask from absolute positions.  ``window`` overrides
    ``cfg.window`` for one layer (0 = global)."""
    m = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    if cfg.causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        if window > 0:
            m &= k_pos[None, :] > q_pos[:, None] - window
    elif cfg.window is not None:
        m &= k_pos[None, :] > q_pos[:, None] - cfg.window
    return m


def sdpa(cfg: AttnConfig, q, k, v, q_pos, k_pos, window: int | None = None):
    """Scaled dot-product attention, GQA-grouped, query-chunked.

    q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd); *_pos: (S,) absolute
    positions."""
    if (cfg.use_flash and window is None and q.shape[1] == k.shape[1]
            and q.shape[1] >= 128):
        return flash.flash_sdpa(q, k, v, scale=cfg.scale, causal=cfg.causal,
                                window=cfg.window or 0)
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, hd)
    out = []
    for c0 in range(0, sq, cfg.chunk_q):
        qb = qg[:, c0:c0 + cfg.chunk_q]                   # (B, Cq, Hkv, G, hd)
        s = torch.einsum("bqhgk,bshk->bhgqs", qb, k) * cfg.scale
        mask = _mask(cfg, q_pos[c0:c0 + cfg.chunk_q], k_pos, window)
        s = s.masked_fill(~mask, NEG_INF)
        w = torch.softmax(s.to(torch.promote_types(s.dtype, torch.float32)),
                          dim=-1).to(q.dtype)
        out.append(torch.einsum("bhgqs,bshk->bqhgk", w, v))
    return torch.cat(out, dim=1).reshape(b, sq, hq, hd)


def attn_forward(p, cfg: AttnConfig, x, positions=None,
                 window: int | None = None):
    """Full-sequence self-attention. x: (B, S, D) -> (B, S, D)."""
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    out = sdpa(cfg, q, k, v, positions, positions, window=window)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def attn_prefill(p, cfg: AttnConfig, x, cache_len: int,
                 window: int | None = None):
    """Forward + a (B, cache_len, Hkv, hd) kv cache holding the prompt's
    keys and values, zeros after them."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    out = sdpa(cfg, q, k, v, positions, positions, window=window)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    cache_k = k.new_zeros((b, cache_len) + k.shape[2:])
    cache_v = v.new_zeros((b, cache_len) + v.shape[2:])
    cache_k[:, :s] = k
    cache_v[:, :s] = v
    return y, (cache_k, cache_v)


def attn_decode(p, cfg: AttnConfig, x, cache_k, cache_v, pos: int,
                window: int | None = None):
    """One-token decode. x: (B, 1, D); cache: (B, T, Hkv, hd); ``pos`` the
    new token's position.

    Returns (y, cache_k, cache_v).  Unlike the reference, which returns
    new arrays, the caches are updated in place (position ``pos`` is
    written): a step does not copy the whole cache."""
    b = x.shape[0]
    positions = torch.full((1,), pos, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    t = cache_k.shape[1]
    k_pos = torch.arange(t, device=x.device)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qg = q.reshape(b, 1, hkv, hq // hkv, hd)
    s = torch.einsum("bqhgk,bshk->bhgqs", qg, cache_k.to(x.dtype)) * cfg.scale
    valid = k_pos <= pos
    if window is not None:
        if window > 0:
            valid &= k_pos > pos - window
    elif cfg.window is not None:
        valid &= k_pos > pos - cfg.window
    s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhgqs,bshk->bqhgk", w, cache_v.to(x.dtype))
    y = torch.einsum("bshk,hkd->bsd", out.reshape(b, 1, hq, hd),
                     p["wo"].to(x.dtype))
    return y, cache_k, cache_v


# ---------------------------------------------------------------------------
# cross-attention (enc-dec; whisper)
# ---------------------------------------------------------------------------

def cross_attn_spec(cfg: AttnConfig) -> dict:
    return attn_spec(cfg)


def cross_attn(p, cfg: AttnConfig, x, enc_kv):
    """x: (B, S, D) queries; enc_kv: (k, v), each (B, T, Hkv, hd),
    precomputed by :func:`cross_kv`.  Not causal, no window, no RoPE."""
    s = x.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    k, v = enc_kv
    cfg_x = dataclasses.replace(cfg, causal=False, window=None,
                                use_rope=False)
    q_pos = torch.arange(s, device=x.device)
    k_pos = torch.arange(k.shape[1], device=x.device)
    out = sdpa(cfg_x, q, k.to(x.dtype), v.to(x.dtype), q_pos, k_pos)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def cross_kv(p, cfg: AttnConfig, enc_out):
    """Cross-attention k/v of the encoder output (B, T, D), computed once
    and cached: each (B, T, Hkv, hd)."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(enc_out.dtype))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(enc_out.dtype))
    if cfg.qkv_bias:
        k = k + p["bk"].to(enc_out.dtype)
        v = v + p["bv"].to(enc_out.dtype)
    return k, v
