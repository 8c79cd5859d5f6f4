"""Parameter specs and shared layers (norms, RoPE, MLPs, embeddings), the
twins of ``repro.models.layers``.

A module describes its parameters as a tree of :class:`ParamSpec`s;
:func:`init_params` materialises the tree as a :class:`Params` module
whose leaves are tensors.  The layer functions take such a tree (or any
mapping with the same keys) and tensors in the reference's layouts.
``layernorm`` and ``gelu_mlp`` are not ported yet (ROADMAP queue 1 #8).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    init: str = "normal"                  # normal | zeros | ones | embed
    scale: float | None = None            # stddev override for "normal"


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


def init_params(spec_tree, generator: torch.Generator,
                dtype=torch.float32) -> Params:
    """Materialise a ParamSpec tree on the generator's device: zeros for
    biases, ones for norms, normal draws from ``generator`` (leaf by leaf,
    depth first) for the rest, with std ``scale``, 0.02 for embeddings,
    else 1/sqrt(fan-in) (a matrix's ``shape[0]``)."""
    dev = generator.device

    def make(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        if spec.scale is not None:
            std = spec.scale
        elif spec.init == "embed":
            std = 0.02
        else:  # fan-in
            fan_in = spec.shape[0] if len(spec.shape) > 1 else spec.shape[-1]
            std = 1.0 / math.sqrt(max(fan_in, 1))
        draw = torch.randn(spec.shape, generator=generator, device=dev)
        return (std * draw).to(dtype)

    return Params(_map(spec_tree, make))


def param_count(spec_tree) -> int:
    return sum(math.prod(s.shape) for s in _leaves(spec_tree))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_spec(d: int):
    return {"scale": ParamSpec((d,), init="ones")}


def rmsnorm(p, x, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * p["scale"].to(dt)


# ---------------------------------------------------------------------------
# dense / embedding
# ---------------------------------------------------------------------------

def dense_spec(d_in: int, d_out: int):
    return {"w": ParamSpec((d_in, d_out))}


def dense(p, x):
    return x @ p["w"].to(x.dtype)


def embedding_spec(vocab: int, d: int):
    return {"table": ParamSpec((vocab, d), init="embed")}


def embed(p, tokens):
    return p["table"][tokens]


def unembed(p, x):
    """Tied readout: x (..., d) @ table^T -> (..., vocab)."""
    return x @ p["table"].to(x.dtype).T


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu_spec(d: int, d_ff: int):
    return {"gate": dense_spec(d, d_ff), "up": dense_spec(d, d_ff),
            "down": dense_spec(d_ff, d)}


def swiglu(p, x):
    return dense(p["down"], torch.nn.functional.silu(dense(p["gate"], x))
                 * dense(p["up"], x))


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
    convention, angles in float32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)             # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
