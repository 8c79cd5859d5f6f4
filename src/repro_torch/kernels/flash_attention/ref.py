"""Oracle: naive softmax attention with the same mask semantics as the
kernel (the twin of ``repro.kernels.flash_attention.ref``)."""
from __future__ import annotations

import torch


def flash_attention_ref(q, k, v, *, scale=None, causal=True, window=0):
    """q: (B, Hq, S, hd); k/v: (B, Hkv, S, hd) -> (B, Hq, S, hd).  Masked
    logits are -1e30; softmax in float32; output in q's type."""
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(b, hkv, g, s, hd)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= kp > qp - window
    logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w, v.float())
    return out.reshape(b, hq, s, hd).to(q.dtype)
