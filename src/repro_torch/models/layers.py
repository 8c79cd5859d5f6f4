"""Parameter specs and shared layers (norms, RoPE, MLPs, embeddings), the
twins of ``repro.models.layers``.

A module describes its parameters as a tree of :class:`ParamSpec`s;
:func:`init_params` materialises the tree as a :class:`Params` module
whose leaves are tensors, either from a ``torch.Generator`` or, as the
reference does, from a JAX key through the threefry twin.  The layer
functions take such a tree (or any mapping with the same keys, such as
:meth:`Params.tree`'s plain dicts) and tensors in the reference's
layouts.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.core import prng
from repro_torch.core.tree import Layers, entries, rebuild


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis name per dim
    init: str = "normal"                  # normal | zeros | ones | embed
    scale: float | None = None            # stddev override for "normal"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


class Params(nn.Module):
    """A tree of parameters: each key holds a tensor, a sub-tree, or a
    list of sub-trees (the layers of a segment, looped in Python).
    Indexed like the reference's dict (``p["attn"]["wq"]``); its tensors
    are frozen ``nn.Parameter``s."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, torch.Tensor):
                self.register_parameter(key, nn.Parameter(
                    val, requires_grad=False))
            elif isinstance(val, list):
                self.add_module(key, nn.ModuleList(Params(t) for t in val))
            else:
                self.add_module(key, Params(val))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def tree(self) -> dict:
        """The parameters as plain nested dicts (and per-layer lists) of
        their tensors, detached, sharing storage: the train path's
        parameter tree."""
        out: dict = {k: p.detach() for k, p in self._parameters.items()}
        for k, m in self._modules.items():
            out[k] = ([t.tree() for t in m] if isinstance(m, nn.ModuleList)
                      else m.tree())
        return out


def _leaves(spec_tree):
    """The tree's ParamSpecs in a fixed depth-first order."""
    if isinstance(spec_tree, ParamSpec):
        yield spec_tree
    elif isinstance(spec_tree, list):
        for t in spec_tree:
            yield from _leaves(t)
    else:
        for t in spec_tree.values():
            yield from _leaves(t)


def _map(spec_tree, fn):
    if isinstance(spec_tree, ParamSpec):
        return fn(spec_tree)
    if isinstance(spec_tree, list):
        return [_map(t, fn) for t in spec_tree]
    return {k: _map(t, fn) for k, t in spec_tree.items()}


def _std(spec: ParamSpec) -> float:
    """The normal draw's std: ``scale``, 0.02 for embeddings, else
    1/sqrt(fan-in) (a matrix's ``shape[0]``)."""
    if spec.scale is not None:
        return spec.scale
    if spec.init == "embed":
        return 0.02
    fan_in = spec.shape[0] if len(spec.shape) > 1 else spec.shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


def abstract_params(spec_tree, dtype=torch.float32):
    """The parameter tree as meta tensors: shapes and dtypes, no storage
    (the dry run's stand-in for the reference's ShapeDtypeStructs)."""
    return _map(spec_tree, lambda s: torch.empty(s.shape, dtype=dtype,
                                                 device="meta"))


def logical_axes(spec_tree):
    """The tree of logical-axis tuples mirroring the parameter tree."""
    return _map(spec_tree, lambda s: s.axes)


def stacked_spec(like) -> ParamSpec:
    """The reference's spec of a leaf: a layer list's per-layer specs
    (a :class:`repro_torch.core.tree.Layers`) as one spec with the layer
    count as a leading axis; a spec as itself."""
    if isinstance(like, Layers):
        s = like[0]
        return ParamSpec((len(like),) + s.shape, ("layers",) + s.axes,
                         s.init, s.scale)
    return like


def init_params(spec_tree, source, dtype=torch.float32,
                device=None) -> Params:
    """Materialise a ParamSpec tree: zeros for biases, ones for norms,
    ``std`` times normal draws for the rest (std: ``scale``, 0.02 for
    embeddings, else 1/sqrt(fan-in), a matrix's ``shape[0]``).

    ``source`` is either a ``torch.Generator`` (draws from it leaf by
    leaf, depth first, per-layer shapes, on the generator's device;
    ``device`` is ignored) or a JAX key (a ``(2,)`` uint32 array), which
    gives the reference's ``init_params`` weights: leaf ``i`` of the
    reference's flatten order (layers stacked, :func:`stacked_spec`) is
    ``std * normal(fold_in(key, i))`` with ``std`` taken from the stacked
    shape, drawn on ``device`` by the threefry twin
    (:func:`repro_torch.core.prng.normal_torch`) and split back into
    per-layer tensors (views of the stacked draw)."""
    def make(spec: ParamSpec, normal, dev) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        return normal(spec.shape).mul_(_std(spec)).to(dtype)

    if isinstance(source, torch.Generator):
        dev = source.device
        return Params(_map(spec_tree, lambda spec: make(
            spec, lambda shape: torch.randn(shape, generator=source,
                                            device=dev), dev)))
    key = prng.as_key(source)
    index = {k: i for i, (k, _) in enumerate(entries(spec_tree))}
    return Params(rebuild(spec_tree, lambda k, like: make(
        stacked_spec(like), lambda shape: prng.normal_torch(
            prng.fold_in(key, index[k]), shape, device), device)))


def param_count(spec_tree) -> int:
    return sum(math.prod(s.shape) for s in _leaves(spec_tree))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_spec(d: int):
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def rmsnorm(p, x, eps: float = 1e-6):
    """In float32, or float64 for a float64 ``x``."""
    dt = x.dtype
    x32 = x.to(torch.promote_types(dt, torch.float32))
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * p["scale"].to(dt)


def layernorm_spec(d: int):
    return {"scale": ParamSpec((d,), ("embed",), init="ones"),
            "bias": ParamSpec((d,), ("embed",), init="zeros")}


def layernorm(p, x, eps: float = 1e-5):
    """In float32, or float64 for a float64 ``x``; the (biased) variance
    over the last axis, as ``jnp.var``."""
    dt = x.dtype
    x32 = x.to(torch.promote_types(dt, torch.float32))
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * p["scale"].to(dt) + p["bias"].to(dt)


# ---------------------------------------------------------------------------
# dense / embedding
# ---------------------------------------------------------------------------

def dense_spec(d_in: int, d_out: int, axes: tuple[str | None, str | None],
               bias: bool = False, scale: float | None = None):
    spec = {"w": ParamSpec((d_in, d_out), axes, scale=scale)}
    if bias:
        spec["b"] = ParamSpec((d_out,), (axes[1],), init="zeros")
    return spec


def dense(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embedding_spec(vocab: int, d: int):
    return {"table": ParamSpec((vocab, d), ("vocab", "embed"), init="embed")}


def embed(p, tokens):
    return p["table"][tokens]


def unembed(p, x):
    """Tied readout: x (..., d) @ table^T -> (..., vocab)."""
    return x @ p["table"].to(x.dtype).T


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu_spec(d: int, d_ff: int):
    return {"gate": dense_spec(d, d_ff, ("embed", "mlp")),
            "up": dense_spec(d, d_ff, ("embed", "mlp")),
            "down": dense_spec(d_ff, d, ("mlp", "embed"))}


def swiglu(p, x):
    return dense(p["down"], torch.nn.functional.silu(dense(p["gate"], x))
                 * dense(p["up"], x))


def gelu_mlp_spec(d: int, d_ff: int, bias: bool = True):
    return {"up": dense_spec(d, d_ff, ("embed", "mlp"), bias=bias),
            "down": dense_spec(d_ff, d, ("mlp", "embed"), bias=bias)}


def gelu_mlp(p, x):
    """``jax.nn.gelu``'s default form: the tanh approximation."""
    return dense(p["down"], torch.nn.functional.gelu(dense(p["up"], x),
                                                     approximate="tanh"))


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integers.  Half-split
    convention, angles in float32; the rotation in float32, or float64
    for a float64 ``x``."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)             # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.promote_types(x.dtype, torch.float32)).chunk(
        2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
