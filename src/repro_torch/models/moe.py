"""Mixture-of-Experts: shared + routed top-k experts with capacity
dispatch — the twin of ``repro.models.moe``.

Router: softmax top-k with renormalised weights, plus the standard
load-balance auxiliary loss (fraction x probability x E).  Dispatch is
sort-based: a stable sort of the (token, choice) pairs by expert id,
each pair's position within its expert, and an (E, C, D) buffer of the
first C pairs of every expert (C the capacity); the pairs past it are
dropped, exactly those the reference drops:

* the top k in the order of ``jax.lax.top_k`` (ties: the lower expert
  first), taken from a stable descending sort;
* the sort by expert id stable, as ``jnp.argsort``;
* ``capacity = int(capacity_factor * k * T / E) + 1`` in the same Python
  arithmetic;
* the reference's ``.at[...].set(mode="drop")`` as an explicit keep
  mask.

The buffer is gathered (slot c of expert e holds sorted pair
``start[e] + c``) and the combine is an unsort, each token's k
contributions added in expert order, so no step is a scatter and every
run on every device gives the same sums.  DeepSeek-style shared experts
are a plain dense SwiGLU alongside.

The port has one token group: the reference groups tokens by its
expert-parallel mesh axes (``CURRENT_MESH``, ``_ep_axes``, ``_pin``) and
has one group without a mesh; those pieces come with the port's meshes
(ROADMAP queue 1 #7).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, swiglu, swiglu_spec


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-3


def moe_spec(cfg: MoEConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    spec = {
        "router": ParamSpec((d, e), scale=0.02),
        "gate": ParamSpec((e, d, f)),
        "up": ParamSpec((e, d, f)),
        "down": ParamSpec((e, f, d)),
    }
    if cfg.n_shared:
        spec["shared"] = swiglu_spec(d, cfg.n_shared * f)
    return spec


def capacity_of(cfg: MoEConfig, tokens: int) -> int:
    """Slots per expert for one group of ``tokens`` tokens."""
    return int(cfg.capacity_factor * cfg.top_k * tokens / cfg.n_experts) + 1


def _route_group(p, cfg: MoEConfig, xt, capacity: int):
    """Dispatch one token group: (T, D) -> (buffer (E, C, D), combine
    metadata, fe (E,), pe (E,)).  The metadata is (e_sort, t_sort,
    w_sort, pos, keep, inv): each (T*k,) pair in expert order, and the
    unsorting permutation."""
    tg, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    ct = torch.promote_types(xt.dtype, torch.float32)
    logits = xt.to(ct) @ p["router"].to(ct)
    probs = torch.softmax(logits, dim=-1)                # (T, E)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)

    e_flat = top_i.reshape(-1)
    counts = torch.zeros((e,), dtype=ct, device=xt.device).index_add(
        0, e_flat, torch.ones_like(e_flat, dtype=ct))
    pe = probs.mean(dim=0)
    fe = counts / (tg * k)

    t_flat = torch.arange(tg, device=xt.device).repeat_interleave(k)
    order = torch.argsort(e_flat, stable=True)
    e_sort, t_sort = e_flat[order], t_flat[order]
    w_sort = top_w.reshape(-1)[order]
    n_e = counts.long()
    start = torch.cumsum(n_e, dim=0) - n_e               # first pair of e
    pos = torch.arange(tg * k, device=xt.device) - start[e_sort]
    keep = pos < capacity

    slot = torch.arange(capacity, device=xt.device)
    src = (start[:, None] + slot[None, :]).clamp_max(tg * k - 1)   # (E, C)
    filled = slot[None, :] < n_e[:, None]
    buf = torch.where(filled[..., None], xt[t_sort[src]], 0.0)
    inv = torch.argsort(order)
    return buf, (e_sort, t_sort, w_sort, pos, keep, inv), fe, pe


def _combine_group(out, meta, tg: int, dtype):
    """(E, C, D) expert outputs -> (T, D): each kept pair's output times
    its weight, each token's pairs added in expert order."""
    e_sort, _, w_sort, pos, keep, inv = meta
    capacity = out.shape[1]
    gathered = out[e_sort, torch.where(keep, pos, capacity - 1)]
    gathered = torch.where(keep[:, None], gathered, 0.0)
    contrib = gathered * w_sort[:, None].to(dtype)
    k = inv.shape[0] // tg
    at = torch.sort(inv.reshape(tg, k), dim=-1).values   # expert order
    y = contrib[at[:, 0]]
    for j in range(1, k):
        y = y + contrib[at[:, j]]
    return y


def moe_forward(p, cfg: MoEConfig, x):
    """x: (B, S, D) -> (y (B, S, D), aux_loss), the B*S tokens routed as
    one group."""
    b, s_len, d = x.shape
    t = b * s_len
    e = cfg.n_experts
    capacity = capacity_of(cfg, t)
    xt = x.reshape(t, d)
    buf, meta, fe, pe = _route_group(p, cfg, xt, capacity)
    aux = cfg.aux_loss_weight * e * torch.sum(fe * pe)

    gt = torch.bmm(buf, p["gate"].to(x.dtype))          # (E, C, F)
    u = torch.bmm(buf, p["up"].to(x.dtype))
    out = torch.bmm(F.silu(gt) * u, p["down"].to(x.dtype))   # (E, C, D)
    y = _combine_group(out, meta, t, x.dtype)
    if cfg.n_shared:
        y = y + swiglu(p["shared"], xt)
    return y.reshape(b, s_len, d), aux
