"""Gradient optimizers for LM training, the twins of
``repro.optim.gradient``: AdamW and SGD as plain functions on the port's
parameter trees (dicts and per-layer lists of tensors, see
:mod:`repro_torch.core.tree`; no tuples inside a parameter tree).

Updates are functional, as the reference's: ``update(grads, state,
params) -> (new_params, new_state)``, computed without autograd, moments
stored in ``moment_dtype`` and the update itself in float32.  The states
are NamedTuples whose ``step`` is a 0-d int32 tensor, so a checkpoint of
``(params, state)`` has the reference's leaves (``[1]/.step``,
``[1]/.mu/...``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # moment storage dtype ("bfloat16" halves optimizer memory; the update
    # math always runs in float32)
    moment_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    lr: float = 1e-2
    momentum: float = 0.9
    grad_clip: float = 0.0


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


class SGDState(NamedTuple):
    step: torch.Tensor
    velocity: Any


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac`` (float32)."""
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    return tree_map(lambda g: g * scale, grads), norm


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def adamw_init(params, moment_dtype=torch.float32) -> AdamWState:
    def zeros(p):
        return torch.zeros_like(p, dtype=moment_dtype)
    return AdamWState(step=_step0(params), mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params):
    if cfg.grad_clip > 0:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    step_f = step.float()
    lr = _schedule(cfg, step_f)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - torch.pow(_f32(b1, step_f), step_f)
    c2 = 1 - torch.pow(_f32(b2, step_f), step_f)
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(g, m, v, p):
        g = g.float()
        m = b1 * m.float() + (1 - b1) * g
        v = b2 * v.float() + (1 - b2) * g * g
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m.to(mdt), v.to(mdt)

    flat = tree_map(upd, grads, state.mu, state.nu, params)
    return _pick(flat, 0), AdamWState(step=step, mu=_pick(flat, 1),
                                      nu=_pick(flat, 2))


def _pick(flat, i: int):
    """The ``i``-th element of every per-leaf result tuple of ``flat``."""
    if isinstance(flat, dict):
        return {k: _pick(t, i) for k, t in flat.items()}
    if isinstance(flat, list):
        return [_pick(t, i) for t in flat]
    return flat[i]


def sgd_init(params) -> SGDState:
    return SGDState(step=_step0(params), velocity=tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params))


@torch.no_grad()
def sgd_update(cfg: SGDConfig, grads, state: SGDState, params):
    if cfg.grad_clip > 0:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)

    def upd(g, v, p):
        v = cfg.momentum * v + g.float()
        return (p.float() - cfg.lr * v).to(p.dtype), v

    flat = tree_map(upd, grads, state.velocity, params)
    return _pick(flat, 0), SGDState(step=state.step + 1,
                                    velocity=_pick(flat, 1))


def make_optimizer(cfg):
    """(init, update) pair for either config — the trainer's interface."""
    if isinstance(cfg, AdamWConfig):
        return adamw_init, lambda g, s, p: adamw_update(cfg, g, s, p)
    if isinstance(cfg, SGDConfig):
        return sgd_init, lambda g, s, p: sgd_update(cfg, g, s, p)
    raise TypeError(f"unknown optimizer config {type(cfg)}")
