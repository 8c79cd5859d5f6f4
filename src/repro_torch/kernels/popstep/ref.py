"""Plain PyTorch oracle for the fused population step: the unfused
generate -> decode -> evaluate -> argmin pipeline of ``core.*``.

Selection is ``jnp.argmin``'s: a NaN child wins (the first NaN), else the
smallest value, ties to the smallest index."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.encoding import Encoding, decode
from repro_torch.core.population import generate_children, generate_population
from repro_torch.kernels._plain import argmin_nan_first


def popstep_ref(f_batch: Callable[[torch.Tensor], torch.Tensor],
                parent_bits: torch.Tensor,
                enc: Encoding) -> tuple[torch.Tensor, torch.Tensor]:
    """(N,) int8 parent -> (best child value, best child id) over 2N-1."""
    children = generate_population(parent_bits)          # (P, N)
    vals = f_batch(decode(children, enc))                # (P,)
    i = argmin_nan_first(vals)
    return vals[i].to(torch.float32), i.to(torch.int32)


def popstep_subset_ref(f_batch: Callable[[torch.Tensor], torch.Tensor],
                       parent_bits: torch.Tensor, child_ids: torch.Tensor,
                       enc: Encoding) -> tuple[torch.Tensor, torch.Tensor]:
    """Oracle for an arbitrary id subset (virtual-processing blocks)."""
    children = generate_children(parent_bits, child_ids)
    vals = f_batch(decode(children, enc))
    i = argmin_nan_first(vals)
    return vals[i].to(torch.float32), child_ids[i].to(torch.int32)
