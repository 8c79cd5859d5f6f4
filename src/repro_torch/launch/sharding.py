"""Logical-axis -> mesh sharding rules (MaxText-style) with divisibility
fallback, the twins of ``repro.launch.sharding``, as DTensor placements.

Training: FSDP shards the "embed"/"vocab-adjacent" storage dims over the
batch axes (pod, data); TP shards heads/mlp/experts over "model".  A rule
whose mesh axes don't divide the tensor dim (qwen2's 12 heads on a
16-way model axis; whisper's odd 51865 vocab) falls back to replication
for that dim: the framework never refuses a config, it degrades its
sharding.

Serving: parameters replicate over the batch axes and keep TP over
"model"; caches shard batch over (pod, data), or the sequence dim when
the batch is too small (long_500k's B=1).

A layout is a :class:`Layout`: a mesh (a ``DeviceMesh``, or a plain
``{axis: size}`` mapping, which needs no process group) and one DTensor
placement a mesh dimension.  A tensor dim split over ``("pod", "data")``
is ``Shard(d)`` on both mesh dims; DTensor splits it over the mesh dims
in order, pod-major, as JAX's ``PartitionSpec(("pod", "data"))`` does.
:meth:`Layout.spec` spells a layout as such a partition spec.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch.mesh import _shape

FSDP_AXES = ("pod", "data")

# Experts shard over the FSDP/batch axes (expert parallelism: tokens
# all-to-all across the data axis to reach their experts) x TP on the
# expert FFN dim, which keeps expert weight-gradients local.
TRAIN_RULES: dict[str, tuple[str, ...]] = {
    "vocab": ("model",),
    "embed": FSDP_AXES,
    "mlp": ("model",),
    "expert_mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": FSDP_AXES,
    "kv_lora": FSDP_AXES,
    "q_lora": FSDP_AXES,
}

SERVE_RULES: dict[str, tuple[str, ...]] = {
    "vocab": ("model",),
    "mlp": ("model",),
    "expert_mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": FSDP_AXES,      # EP persists at serve time (weights too big)
}


@dataclasses.dataclass(frozen=True, eq=False)
class Layout:
    """A tensor's layout over a mesh: one placement a mesh dimension."""
    mesh: Any
    placements: tuple

    @property
    def shape(self) -> dict:
        return _shape(self.mesh)

    def spec(self, ndim: int) -> tuple:
        """The JAX-style partition spec: per tensor dim None, an axis
        name, or a tuple of them (mesh order); trailing Nones dropped."""
        names = list(self.shape)
        parts: list[Any] = [[] for _ in range(ndim)]
        for name, pl in zip(names, self.placements):
            if isinstance(pl, Shard):
                parts[pl.dim].append(name)
        out = [None if not p else (p[0] if len(p) == 1 else tuple(p))
               for p in parts]
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The per-device shape of a tensor of ``shape``."""
        sizes = list(self.shape.values())
        out = list(shape)
        for size, pl in zip(sizes, self.placements):
            if isinstance(pl, Shard):
                out[pl.dim] = -(-out[pl.dim] // size)
        return tuple(out)

    def nbytes(self, t: torch.Tensor) -> int:
        """Bytes of ``t`` (a meta tensor or a spec) on one device."""
        return math.prod(self.shard_shape(t.shape)) * t.element_size()

    def __eq__(self, other):
        return (isinstance(other, Layout) and self.shape == other.shape
                and tuple(self.placements) == tuple(other.placements))

    def __hash__(self):
        return hash((tuple(self.shape.items()), tuple(self.placements)))


def _present(axes: tuple[str, ...], shape: dict) -> tuple[str, ...]:
    return tuple(a for a in axes if a in shape)


def placements_of(parts: Sequence, shape: dict) -> tuple:
    """Placements of a JAX-style spec (per tensor dim None, an axis or a
    tuple of axes)."""
    pl = {a: Replicate() for a in shape}
    for d, entry in enumerate(parts):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            pl[a] = Shard(d)
    return tuple(pl[a] for a in shape)


def spec_for(shape: tuple[int, ...], logical: tuple[str | None, ...],
             mesh, rules: dict[str, tuple[str, ...]]) -> tuple:
    """DTensor placements for one tensor; each mesh axis used at most
    once; non-divisible dims fall back to replication (the largest prefix
    of the rule's axis tuple whose product divides the dim is kept)."""
    msh = _shape(mesh)
    used: set[str] = set()
    parts: list[Any] = []
    for dim, name in zip(shape, logical):
        entry = None
        if name is not None and name in rules:
            axes = [a for a in _present(rules[name], msh) if a not in used]
            keep: list[str] = []
            prod = 1
            for a in axes:
                if dim % (prod * msh[a]) == 0:
                    keep.append(a)
                    prod *= msh[a]
            if keep:
                entry = tuple(keep) if len(keep) > 1 else keep[0]
                used.update(keep)
        parts.append(entry)
    return placements_of(parts, msh)


def _map_axes(fn, axes_tree, tree):
    """``fn(axes, leaf)`` over an axes tree (tuples are its leaves) and
    the matching tree of tensors."""
    if isinstance(axes_tree, tuple):
        return fn(axes_tree, tree)
    if isinstance(axes_tree, list):
        return [_map_axes(fn, a, t) for a, t in zip(axes_tree, tree)]
    return {k: _map_axes(fn, a, tree[k]) for k, a in axes_tree.items()}


def param_shardings(axes_tree, spec_tree, mesh,
                    rules: dict[str, tuple[str, ...]]):
    """Tree of :class:`Layout`s for a parameter tree.  ``axes_tree``:
    logical-axis tuples (``models.layers.logical_axes``); ``spec_tree``:
    the matching tree of (meta) tensors, for shapes."""
    return _map_axes(
        lambda axes, t: Layout(mesh, spec_for(tuple(t.shape), axes, mesh,
                                              rules)),
        axes_tree, spec_tree)


def batch_sharding(mesh, ndim: int, batch_dim: int = 0) -> Layout:
    """Shard the batch dim over (pod, data)."""
    msh = _shape(mesh)
    axes = _present(FSDP_AXES, msh)
    parts: list[Any] = [None] * ndim
    parts[batch_dim] = tuple(axes) if len(axes) > 1 else axes[0]
    return Layout(mesh, placements_of(parts, msh))


def cache_shardings(cache_spec, mesh, *, batch: int, cache_len: int,
                    head_counts: Sequence[int]):
    """Heuristic layouts for a serve cache tree (the port's: per-layer
    lists of tuples of tensors, ints kept as they are).

    Per tensor: a dim equal to ``batch`` shards over (pod, data) when
    divisible; otherwise a dim equal to ``cache_len`` does
    (sequence-parallel long-context decode); a dim matching a known head
    count shards over "model" when divisible.  The reference's stacked
    layer axis is not there: the port's cache entries are per layer."""
    msh = _shape(mesh)
    baxes = _present(FSDP_AXES, msh)
    bsize = math.prod(msh[a] for a in baxes)
    bspec = tuple(baxes) if len(baxes) > 1 else baxes[0]

    def one(t):
        if not isinstance(t, torch.Tensor) or t.ndim == 0:
            return Layout(mesh, placements_of((), msh))
        parts: list[Any] = [None] * t.ndim
        used_batch = False
        for i, d in enumerate(t.shape):
            if not used_batch and d == batch and d % bsize == 0:
                parts[i] = bspec
                used_batch = True
            elif not used_batch and d == cache_len and d % bsize == 0:
                parts[i] = bspec
                used_batch = True
            elif (d in head_counts and d % msh["model"] == 0
                  and "model" not in [p for p in parts if p]):
                parts[i] = "model"
        return Layout(mesh, placements_of(parts, msh))

    return _map_tensors(one, cache_spec)


def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, t) for k, t in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, t) for t in tree)
    return fn(tree)


def replicated(mesh) -> Layout:
    return Layout(mesh, placements_of((), _shape(mesh)))


class _Reshard(torch.autograd.Function):
    """Forward: redistribute to the use layout.  Backward: the cotangent
    redistributed to the storage (gradient) layout."""

    @staticmethod
    def forward(ctx, x, use, grad):
        ctx.grad = grad
        return x.redistribute(x.device_mesh, use)

    @staticmethod
    def backward(ctx, ct):
        return ct.redistribute(ct.device_mesh, ctx.grad), None, None


def reshard_fwd_bwd(x: DTensor, use: Layout, grad: Layout) -> DTensor:
    """A layout change with an independent cotangent layout: forward to
    ``use`` (the compute layout: FSDP shards gathered once per layer),
    backward to ``grad`` (the FSDP storage layout, so the gradient is
    reduce-scattered, ZeRO-style).  DTensor's own ``redistribute``
    backward returns the cotangent in the input's layout, which for an
    input already in the storage layout is the same thing; this states it
    whatever the input's layout."""
    return _Reshard.apply(x, tuple(use.placements), tuple(grad.placements))
