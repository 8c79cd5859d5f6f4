"""Plain PyTorch twins of the device code that the kernels share
(``csrc/dgo_device.cuh``): the closed-form child of a Gray segment
(``child_level``) and the NaN-first selection rule (``nan_first_better``
with the warp and block folds).  Every kernel package's plain version and
oracle takes them from here."""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:   # core imports the kernels: no import of core at run time
    from repro_torch.core.encoding import Encoding

_INT_MAX = 2**31 - 1


def child_levels(parent_levels: torch.Tensor, starts: torch.Tensor,
                 ends: torch.Tensor, enc: Encoding) -> torch.Tensor:
    """(n_vars,) parent levels + (K,) segments -> (K, n_vars) int64 child
    levels, by the closed-form binary-space pattern (see
    ``core.population.segment_patterns``)."""
    b = enc.bits
    dev = parent_levels.device
    base = torch.arange(enc.n_vars, device=dev) * b              # (n_vars,)
    s = starts.to(torch.int64)[:, None]
    e = ends.to(torch.int64)[:, None]
    lo_t = (s - base).clamp(0, b)
    hi_t = (e - base).clamp(0, b)
    one = torch.ones((), dtype=torch.int64, device=dev)
    inside = (one << (b - lo_t)) - (one << (b - hi_t))
    even = sum(1 << (b - 1 - t) for t in range(0, b, 2))
    full = (1 << b) - 1
    alt = torch.where(((s - base) & 1) == 1, full ^ even, even)
    tail = torch.where(((e - s) & 1) == 1, (one << (b - hi_t)) - 1, 0)
    return parent_levels.to(torch.int64) ^ ((inside & alt) | tail)


def nan_first_rows(v: torch.Tensor, r: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row of (K, m) values ``v`` with distinct int64 labels ``r``:
    the NaN-first winner (a NaN wins, smallest label among NaNs; else the
    smallest value, ties to the smallest label) as ((K,) its own value,
    (K,) its label).  The value is the winner's, so a -0.0 stays -0.0."""
    nan = torch.isnan(v)
    nan_row = torch.where(nan, r, _INT_MAX).amin(1)
    vmin = torch.where(nan, torch.inf, v).amin(1)
    min_row = torch.where(~nan & (v == vmin[:, None]), r, _INT_MAX).amin(1)
    row = torch.where(nan.any(1), nan_row, min_row)
    pos = (r == row[:, None]).to(torch.int8).argmax(1, keepdim=True)
    return v.gather(1, pos)[:, 0], row


def argmin_nan_first(vals: torch.Tensor) -> torch.Tensor:
    """Index of the first NaN if any, else of the first minimum."""
    nan = torch.isnan(vals)
    first_nan = nan.to(torch.int32).argmax()
    first_min = torch.where(nan, torch.inf, vals).argmin()
    return torch.where(nan.any(), first_nan, first_min)
