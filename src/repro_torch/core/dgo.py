"""DGO configuration: the paper's resolution schedule (steps 5/6).

Only :class:`DGOConfig` is here so far — the host-chained schedule of the
distributed engine needs it.  The single-device fused, clustered and
sequential engines of ``repro.core.dgo`` wait for their port.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.encoding import Encoding


@dataclasses.dataclass(frozen=True)
class DGOConfig:
    """Resolution schedule + iteration caps (paper steps 5/6)."""

    encoding: Encoding                 # starting resolution
    max_bits: int = 16                 # maximum resolution (paper step 6)
    bits_step: int = 2                 # resolution increment on stall
    max_iters_per_resolution: int = 512  # safety cap on step-4 loops

    def resolutions(self) -> list[int]:
        return list(range(self.encoding.bits, self.max_bits + 1, self.bits_step))
