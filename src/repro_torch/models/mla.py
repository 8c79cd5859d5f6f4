"""Multi-head Latent Attention (DeepSeek-V2/V3) — the twin of
``repro.models.mla``.

Train / prefill use the expanded form (per-head k_nope / v decompressed
— the form DeepSeek trains in), query-chunked and plain, as the
reference's (which never takes its flash kernel: q/k head_dim 192, v
128).  Decode uses the *absorbed* form: W_uk is folded into the query
and W_uv into the output, so the per-token cache is just the compressed
latent ``c_kv (kv_lora) ⊕ k_rope (rope_dim)``, and decode attends
MQA-style over a (B, T, kv_lora + rope_dim) cache: no per-head K/V is
ever materialised at decode.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import ParamSpec, apply_rope, rmsnorm, rmsnorm_spec

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536            # 0 = direct q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10_000.0
    chunk_q: int = 512

    @property
    def scale(self) -> float:
        return (self.qk_nope_head_dim + self.qk_rope_head_dim) ** -0.5

    @property
    def cache_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim


def mla_spec(cfg: MLAConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    spec: dict = {}
    if cfg.q_lora_rank:
        spec["w_dq"] = ParamSpec((d, cfg.q_lora_rank), ("embed", "q_lora"))
        spec["q_norm"] = rmsnorm_spec(cfg.q_lora_rank)
        spec["w_uq"] = ParamSpec((cfg.q_lora_rank, h, dn + dr),
                                  ("q_lora", "heads", "head_dim"))
    else:
        spec["w_q"] = ParamSpec((d, h, dn + dr),
                                 ("embed", "heads", "head_dim"))
    spec["w_dkv"] = ParamSpec((d, cfg.kv_lora_rank + dr),
                              ("embed", "kv_lora"))
    spec["kv_norm"] = rmsnorm_spec(cfg.kv_lora_rank)
    spec["w_uk"] = ParamSpec((cfg.kv_lora_rank, h, dn),
                             ("kv_lora", "heads", "head_dim"))
    spec["w_uv"] = ParamSpec((cfg.kv_lora_rank, h, dv),
                             ("kv_lora", "heads", "head_dim"))
    spec["w_o"] = ParamSpec((h, dv, d), ("heads", "head_dim", "embed"))
    return spec


def _queries(p, cfg: MLAConfig, x, positions):
    """(q_nope (B, S, H, dn), q_rope (B, S, H, dr) roped)."""
    dn = cfg.qk_nope_head_dim
    if cfg.q_lora_rank:
        cq = rmsnorm(p["q_norm"], x @ p["w_dq"].to(x.dtype))
        q = torch.einsum("bsr,rhk->bshk", cq, p["w_uq"].to(x.dtype))
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["w_q"].to(x.dtype))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _latent(p, cfg: MLAConfig, x, positions):
    """The compressed latent: (c_kv normed (B, S, r), k_rope roped
    (B, S, dr), one head shared by all) — what decode caches."""
    r = cfg.kv_lora_rank
    ckv = x @ p["w_dkv"].to(x.dtype)                     # (B, S, r + dr)
    c, k_rope = ckv[..., :r], ckv[..., r:]
    c = rmsnorm(p["kv_norm"], c)
    k_rope = apply_rope(k_rope[..., None, :], positions,
                        cfg.rope_theta)[..., 0, :]
    return c, k_rope


def _softmax(s, dtype):
    return torch.softmax(s.to(torch.promote_types(s.dtype, torch.float32)),
                         dim=-1).to(dtype)


def _expanded_attention(p, cfg: MLAConfig, q_nope, q_rope, c, k_rope,
                        q_pos, k_pos, causal=True):
    """Training-form attention with decompressed per-head K / V, over
    blocks of ``chunk_q`` queries (only a (Cq, Sk) block of scores a
    head exists at a time).  Returns (B, Sq, D)."""
    dt = q_nope.dtype
    k_nope = torch.einsum("bsr,rhk->bshk", c, p["w_uk"].to(dt))
    v = torch.einsum("bsr,rhk->bshk", c, p["w_uv"].to(dt))
    out = []
    for c0 in range(0, q_nope.shape[1], cfg.chunk_q):
        qn = q_nope[:, c0:c0 + cfg.chunk_q]
        qr = q_rope[:, c0:c0 + cfg.chunk_q]
        s = (torch.einsum("bqhk,bshk->bhqs", qn, k_nope)
             + torch.einsum("bqhk,bsk->bhqs", qr, k_rope)) * cfg.scale
        if causal:
            m = q_pos[c0:c0 + cfg.chunk_q, None] >= k_pos[None, :]
            s = s.masked_fill(~m, NEG_INF)
        out.append(torch.einsum("bhqs,bshk->bqhk", _softmax(s, dt), v))
    return torch.einsum("bshk,hkd->bsd", torch.cat(out, dim=1),
                        p["w_o"].to(dt))


def mla_forward(p, cfg: MLAConfig, x, positions=None):
    """Full-sequence causal MLA. x: (B, S, D) -> (B, S, D)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    q_nope, q_rope = _queries(p, cfg, x, positions)
    c, k_rope = _latent(p, cfg, x, positions)
    return _expanded_attention(p, cfg, q_nope, q_rope, c, k_rope,
                               positions, positions)


def mla_prefill(p, cfg: MLAConfig, x, cache_len: int):
    """Forward + the compressed cache (B, cache_len, kv_lora + rope_dim):
    the prompt's latents, zeros after them."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q_nope, q_rope = _queries(p, cfg, x, positions)
    c, k_rope = _latent(p, cfg, x, positions)
    y = _expanded_attention(p, cfg, q_nope, q_rope, c, k_rope,
                            positions, positions)
    cache = x.new_zeros((b, cache_len, cfg.cache_dim))
    cache[:, :s] = torch.cat([c, k_rope], dim=-1)
    return y, cache


def mla_decode(p, cfg: MLAConfig, x, cache, pos: int):
    """Absorbed one-token decode over the compressed cache.

    x: (B, 1, D); cache: (B, T, kv_lora + rope_dim); ``pos`` the new
    token's position.  Returns (y, cache); unlike the reference, which
    returns a new array, the cache is updated in place (position ``pos``
    is written)."""
    r = cfg.kv_lora_rank
    positions = torch.full((1,), pos, device=x.device)
    q_nope, q_rope = _queries(p, cfg, x, positions)      # (B,1,H,dn),(B,1,H,dr)
    c_new, kr_new = _latent(p, cfg, x, positions)
    cache[:, pos] = torch.cat([c_new, kr_new], dim=-1)[:, 0].to(cache.dtype)

    c_t = cache[..., :r].to(x.dtype)                     # (B, T, r)
    kr_t = cache[..., r:].to(x.dtype)                    # (B, T, dr)
    # absorb W_uk into the query: q_tilde (B, 1, H, r)
    q_tilde = torch.einsum("bqhk,rhk->bqhr", q_nope, p["w_uk"].to(x.dtype))
    s = (torch.einsum("bqhr,bsr->bhqs", q_tilde, c_t)
         + torch.einsum("bqhk,bsk->bhqs", q_rope, kr_t)) * cfg.scale
    valid = torch.arange(cache.shape[1], device=x.device) <= pos
    s = s.masked_fill(~valid, NEG_INF)
    ctx = torch.einsum("bhqs,bsr->bqhr", _softmax(s, x.dtype), c_t)
    # absorb W_uv into the output
    out = torch.einsum("bqhr,rhk->bqhk", ctx, p["w_uv"].to(x.dtype))
    return torch.einsum("bshk,hkd->bsd", out, p["w_o"].to(x.dtype)), cache
