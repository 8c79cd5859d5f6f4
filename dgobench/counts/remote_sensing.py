"""Operations and bytes of one popstep launch of the remote-sensing MLP.

The work counted is what a result bitwise equal to evaluating every
child in full needs, from the shapes alone (a copy of the arithmetic of
``chip_smoke.popstep_work_bound``'s needed work): for every live child,
layer 2 (42 x 8 multiply-adds a sample); layer 1 (7 multiply-adds a
sample and unit) only for the hidden units whose weights the child's
Gray segment touches, since the others are bitwise the parent's; and the
parent's layer 1 once a restart.  A multiply-add is 2 operations;
transcendentals are not counted.  Bytes: the rows' tables read once a
launch (start, end, valid, work order: 4 bytes each; the unit mask: 8),
one child id a virtual block, the samples and one-hot labels, and a
restart's parent bits, every child's value written and its (value, id).
"""
from __future__ import annotations

import numpy as np

from dgobench.counts.peaks import step_rows
from dgobench.reference import segment_table

N_IN, N_HIDDEN, N_CLASSES = 7, 42, 8
N_W1B1 = N_IN * N_HIDDEN + N_HIDDEN


def unit_counts(n_bits: int, bits: int) -> np.ndarray:
    """(2N-1,) the hidden units each child recomputes: unit j when its
    Gray segment flips a bit of W1[k, j] (variable 42 k + j, k < 7) or of
    b1[j] (variable 294 + j).  In binary space segment [s, e) flips bit
    t of [s, e) when t - s is even and every bit past e when e - s is
    odd."""
    table = segment_table(n_bits)
    s, e = table[:, :1], table[:, 1:]
    v = np.arange(N_W1B1)
    lo = np.maximum(s, v * bits)
    hi = np.minimum(e, (v + 1) * bits)
    touched = ((lo + ((lo - s) & 1)) < hi) | (((e - s) & 1 == 1)
                                               & ((v + 1) * bits > e))
    w1 = touched[:, :N_IN * N_HIDDEN].reshape(-1, N_IN, N_HIDDEN)
    units = w1.any(1) | touched[:, N_IN * N_HIDDEN:]
    return units.sum(1)


def ops_per_restart_step(config: dict) -> float:
    """Operations of one restart's step over its whole population."""
    n_bits = int(config["n_vars"]) * int(config["bits"])
    m = N_CLASSES * int(config["n_per_class"])
    pop = 2 * n_bits - 1
    units = int(unit_counts(n_bits, int(config["bits"])).sum())
    return float(pop * m * N_HIDDEN * N_CLASSES * 2
                 + (units + N_HIDDEN) * m * N_IN * 2)


def bytes_per_launch(config: dict, live: float) -> float:
    """HBM bytes of one launch that steps ``live`` restarts."""
    n_bits = int(config["n_vars"]) * int(config["bits"])
    m = N_CLASSES * int(config["n_per_class"])
    rows, n_vb = step_rows(2 * n_bits - 1)
    shared = rows * (4 * 4 + 8) + 4 * n_vb + 4 * m * (N_IN + N_CLASSES)
    return float(shared + live * (n_bits + 4 * rows + 8))
