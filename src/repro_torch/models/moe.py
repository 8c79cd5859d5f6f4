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

Without a mesh (``CURRENT_MESH`` unset, as everywhere but the launch
layer's steps) the B*S tokens are one group.  Under a mesh whose
expert-parallel axes (``_ep_axes``: pod, data, as far as they divide E)
are the batch axes, with the expert weights DTensors sharded over them
(``launch/sharding.py``'s "experts" rule), each rank's tokens (its batch
shard) are one of G groups, GShard-style: routed alone with its own
capacity, the (E, C, D) buffer redistributed from group-major to
expert-major (the all-to-all), the experts applied to their local slots
(their FFN dim split over "model", the partial sums reduced), and back;
both redistributes go through :func:`_a2a`, where the dry run counts them
(a CPU mesh's DTensor spells an all-to-all as an all-gather and a chunk).
"""
from __future__ import annotations

import contextvars
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.layers import ParamSpec, swiglu, swiglu_spec

# The mesh of the expert-parallel layout, set by the launch layer around a
# step (``launch.steps.mesh_scoped``); None: one token group.
CURRENT_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_moe_mesh", default=None)


def _mesh_shape(mesh) -> dict:
    """``{axis: size}`` of a DeviceMesh (or of such a mapping)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))


def _ep_axes(n_experts: int, mesh=None):
    """Mesh axes carrying expert parallelism (present + divisible)."""
    mesh = CURRENT_MESH.get() if mesh is None else mesh
    if mesh is None:
        return None
    shape = _mesh_shape(mesh)
    prod, keep = 1, []
    for a in (a for a in ("pod", "data") if a in shape):
        if n_experts % (prod * shape[a]) == 0:
            keep.append(a)
            prod *= shape[a]
    return tuple(keep) or None


def _group_count(n_experts: int, tokens: int, mesh=None) -> int:
    """The reference's G: the EP axes' product when it divides the
    tokens, else 1."""
    mesh = CURRENT_MESH.get() if mesh is None else mesh
    ep = _ep_axes(n_experts, mesh)
    if mesh is None or not ep:
        return 1
    shape = _mesh_shape(mesh)
    g = 1
    for a in ep:
        g *= shape[a]
    return g if tokens % g == 0 else 1


def ep_active(n_experts: int, mesh=None) -> bool:
    """Expert parallelism is on: the EP axes are the mesh's batch axes
    and split the experts more than one way (so a rank's batch shard is
    one token group)."""
    mesh = CURRENT_MESH.get() if mesh is None else mesh
    if mesh is None:
        return False
    ep = _ep_axes(n_experts, mesh)
    shape = _mesh_shape(mesh)
    batch = tuple(a for a in ("pod", "data") if a in shape)
    return bool(ep) and ep == batch and math.prod(
        shape[a] for a in ep) > 1


def _placements(mesh, shard: dict) -> list:
    """Placements from ``{axis: tensor dim or "partial"}`` (others
    replicated)."""
    out = []
    for a in mesh.mesh_dim_names:
        v = shard.get(a)
        out.append(Partial() if v == "partial" else
                   Replicate() if v is None else Shard(v))
    return out


def _pin(x: DTensor, shard: dict) -> DTensor:
    """``x`` redistributed under the current mesh to ``{axis: dim}``."""
    mesh = x.device_mesh
    return x.redistribute(mesh, _placements(mesh, shard))


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
        "router": ParamSpec((d, e), ("embed", None), scale=0.02),
        "gate": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp")),
        "up": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp")),
        "down": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed")),
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


def _ep_mean(v: torch.Tensor, mesh, ep) -> torch.Tensor:
    """The mean of a per-group tensor over the G groups."""
    g = math.prod(_mesh_shape(mesh)[a] for a in ep)
    d = DTensor.from_local(v / g, mesh,
                           _placements(mesh, {a: "partial" for a in ep}),
                           run_check=False)
    return d.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def _a2a(x: DTensor, shard: dict, what: str) -> DTensor:
    """The group-major <-> expert-major redistribute (an all-to-all);
    ``what`` names it ("dispatch" or "return") for the dry run."""
    return _pin(x, shard)


def _moe_ep(p, cfg: MoEConfig, x, mesh):
    """The expert-parallel forward: this rank's (B, S, D) tokens are one
    group; the expert weights are DTensors (E over the EP axes, the FFN
    dim over "model" when it divides)."""
    b, s_len, d = x.shape
    t = b * s_len
    e = cfg.n_experts
    ep = _ep_axes(e, mesh)
    capacity = capacity_of(cfg, t)
    xt = x.reshape(t, d)
    buf, meta, fe, pe = _route_group(p, cfg, xt, capacity)
    aux = cfg.aux_loss_weight * e * torch.sum(
        _ep_mean(fe, mesh, ep) * _ep_mean(pe, mesh, ep))

    tp = any(isinstance(pl, Shard) and pl.dim == 2 and a == "model"
             for a, pl in zip(mesh.mesh_dim_names, p["gate"].placements))
    group_major = DTensor.from_local(buf[None], mesh,
                                     _placements(mesh, {a: 0 for a in ep}),
                                     run_check=False)          # (G,E,C,D)
    expert_major = _a2a(group_major, {a: 1 for a in ep}, "dispatch")
    # a rank's slots, their FFN dim split over "model": partial sums
    partial = _placements(mesh, {**{a: 1 for a in ep},
                                 **({"model": "partial"} if tp else {})})
    be = expert_major.to_local(grad_placements=partial)   # (G, E/G, C, D)
    wg, wu, wd = (p[k].to_local() for k in ("gate", "up", "down"))
    gt = torch.einsum("gecd,edf->gecf", be, wg.to(x.dtype))
    u = torch.einsum("gecd,edf->gecf", be, wu.to(x.dtype))
    out = torch.einsum("gecf,efd->gecd", F.silu(gt) * u, wd.to(x.dtype))
    out = DTensor.from_local(out, mesh, partial, run_check=False)
    if tp:
        out = _pin(out, {a: 1 for a in ep})        # the model-axis sums
    back = _a2a(out, {a: 0 for a in ep}, "return").to_local()[0]
    y = _combine_group(back, meta, t, x.dtype)
    if cfg.n_shared:
        y = y + swiglu(p["shared"], xt)
    return y.reshape(b, s_len, d), aux


def moe_forward(p, cfg: MoEConfig, x):
    """x: (B, S, D) -> (y (B, S, D), aux_loss).  The B*S tokens are
    routed as one group, or, under an expert-parallel mesh with expert
    weights sharded over it (:func:`ep_active`), as this rank's group of
    G (:func:`_moe_ep`)."""
    mesh = CURRENT_MESH.get()
    if (mesh is not None and isinstance(p["gate"], DTensor)
            and ep_active(cfg.n_experts, mesh)):
        return _moe_ep(p, cfg, x, mesh)
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
