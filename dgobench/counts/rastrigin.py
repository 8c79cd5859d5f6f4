"""Operations and bytes of one popstep launch of Rastrigin's function.

Every live child is evaluated over all n terms: a sum in a fixed order
has no part that can be reused bitwise from the parent.  A term,
x^2 - 10 cos(2 pi x) added to the sum, is counted as 6 operations from
its formula (x * x, 2 pi * x, the cosine as one, 10 * cos, the
difference, the add), whatever the cosine costs.  Bytes: the rows'
tables read once a launch (start, end, valid: 4 bytes each), one child
id a virtual block, and a restart's parent bits, every child's value
written and its (value, id).
"""
from __future__ import annotations

from dgobench.counts.peaks import step_rows

# the device kernels a step of this objective launches, as the trace
# names them (a name matches every record that contains it)
KERNELS = ("popstep_kernel",)

OPS_PER_TERM = 6


def ops_per_restart_step(config: dict) -> float:
    n = int(config["n_vars"])
    pop = 2 * n * int(config["bits"]) - 1
    return float(pop * n * OPS_PER_TERM)


def bytes_per_launch(config: dict, live: float) -> float:
    n_bits = int(config["n_vars"]) * int(config["bits"])
    rows, n_vb = step_rows(2 * n_bits - 1)
    return float(rows * 3 * 4 + 4 * n_vb + live * (n_bits + 4 * rows + 8))
