"""Plain reference of ``rastrigin1000``: Rastrigin's function,
``10 n + sum (x_i^2 - 10 cos(2 pi x_i))``, n = 1,000, unshifted."""
from __future__ import annotations

import math

import torch

CHUNK = 4096       # points a call: (4096, 1000) float64 at a time


def state(config: dict) -> dict:
    return {}


def values(x: torch.Tensor, st: dict) -> torch.Tensor:
    """The function at each point of ``x`` (B, n) float64."""
    return 10.0 * x.shape[-1] + (x * x - 10.0 * torch.cos(
        2.0 * math.pi * x)).sum(-1)


def control_values(x: torch.Tensor, st: dict) -> torch.Tensor:
    """The control: each term in bfloat16 (every operation rounded to
    it), the sum accumulated in float32."""
    xb = x.to(torch.bfloat16)
    terms = xb * xb - 10.0 * torch.cos(2.0 * math.pi * xb)
    return 10.0 * x.shape[-1] + terms.to(torch.float32).sum(-1)
