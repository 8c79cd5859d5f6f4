"""Plain PyTorch oracle for popmin: ``jnp.min``/``jnp.argmin`` semantics
(a NaN wins at its first index, else the smallest value, ties to the
smallest index)."""
from __future__ import annotations

import torch

from repro_torch.kernels._plain import argmin_nan_first


def popmin_ref(vals: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(P,) -> (min value, argmin int32) as 0-d tensors."""
    i = argmin_nan_first(vals)
    return vals[i].to(torch.float32), i.to(torch.int32)
