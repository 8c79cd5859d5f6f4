"""Straggler mitigation policy (a copy of ``repro.runtime.straggler``).

DGO-specific: a round's reduce can proceed with any quorum of shards —
children on missing shards are simply not considered this round and are
regenerated deterministically next round (no state is lost because the
population is a pure function of the parent string). The quorum mask is
plumbed through core/distributed.make_distributed_step.

This module hosts the host-side policy: tracking per-shard completion
times and deciding which shards to mask next round.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StragglerPolicy:
    """Mask shards slower than ``factor`` x median for ``cooldown`` rounds."""

    n_shards: int
    factor: float = 3.0
    cooldown: int = 2

    def __post_init__(self):
        self._mask_rounds = np.zeros(self.n_shards, np.int32)

    def update(self, round_times_s: np.ndarray) -> np.ndarray:
        med = np.median(round_times_s)
        slow = round_times_s > self.factor * med
        self._mask_rounds = np.where(
            slow, self.cooldown, np.maximum(self._mask_rounds - 1, 0))
        return self._mask_rounds == 0          # True = participate

    @property
    def quorum_fraction(self) -> float:
        return float(np.mean(self._mask_rounds == 0))
