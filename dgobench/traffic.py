"""The start points of a run: the part of the traffic the seed draws.

A traffic mix is ``traffic/<name>.json``; its ``kind`` names the loop
that reads the rest of it (``loops/<kind>.py``: how many callers, how
wide the waves, when requests arrive).  Every request carries the
configuration's fixed budget (``max_iters``), so the seed changes no
count, no size and no arrival: only the start points, drawn here
uniformly over the configuration's lattice, one stream for the warm-up
and one for the window.
"""
from __future__ import annotations

import numpy as np

from dgobench.reference import Lattice

BLOCK = 512          # start points drawn at a time: one stream per seed


def seed_words(seed: int, stream: int) -> list[int]:
    """Entropy for ``numpy.random.default_rng`` from a seed of any sign
    and size and a stream number."""
    seed = int(seed)
    return [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF,
            int(seed < 0), int(stream)]


class Starts:
    """The start points of one seed and stream, in the order requests are
    sent: ``next()`` gives (levels (n_vars,) int64, x0 (n_vars,)
    float32), the point the lattice decodes those levels to."""

    def __init__(self, lattice: Lattice, seed: int, stream: int):
        self._lattice = lattice
        self._rng = np.random.default_rng(seed_words(seed, stream))
        self._block: np.ndarray | None = None
        self._i = BLOCK

    def next(self) -> tuple[np.ndarray, np.ndarray]:
        if self._i == BLOCK:
            self._block = self._rng.integers(
                0, self._lattice.levels, size=(BLOCK, self._lattice.n_vars),
                dtype=np.int64)
            self._i = 0
        levels = self._block[self._i]
        self._i += 1
        return levels, self._lattice.points_np(levels)
