"""Rastrigin's term table in popstep, on CPU tensors: which steps take it,
the shared memory it needs, and its arithmetic (the parent's levels, the
odd segment's complemented tail, the closed-form level only where the
segment's ends cut) in plain PyTorch, bit for bit the plain version."""
import numpy as np
import pytest
import torch

from repro_torch.core import objectives as tobj
from repro_torch.core.objectives import OBJECTIVE_IDS
from repro_torch.core.population import segment_table
from repro_torch.kernels.popstep import ops

RAST = OBJECTIVE_IDS["rastrigin"]


@pytest.mark.parametrize("obj_id,n_vars,bits,table", [
    (RAST, 9, 8, False),          # serve --dgo's rastrigin:9
    (RAST, 9, 16, False),         # the schedule's finest resolution
    (RAST, 1000, 16, False),      # a table of 2^16 levels would not fit
    (RAST, 1000, 9, False),
    (RAST, 63, 8, False),
    (RAST, 64, 8, True),
    (RAST, 1000, 8, True),        # the r1000 cell
    (RAST, 1000, 4, True),
    (OBJECTIVE_IDS["ackley"], 1000, 8, False),
    (OBJECTIVE_IDS["remote_sensing"], 680, 4, False),
])
def test_which_steps_take_the_term_table(obj_id, n_vars, bits, table):
    assert ops.term_table(obj_id, n_vars, bits) is table


@pytest.mark.parametrize("n_vars,bits", [(1000, 8), (64, 8), (200, 4)])
def test_the_table_shares_the_child_points_area(n_vars, bits):
    """The table (32 copies of 2^bits levels) lies where the warps' child
    points would: the block needs the larger of the two."""
    kernel = tobj.get("rastrigin", n=n_vars).kernel
    enc = tobj.get("rastrigin", n=n_vars).encoding.with_bits(bits)
    points = ops._smem_bytes(kernel, enc)
    with_table = ops._smem_bytes(kernel, enc, table=True)
    assert with_table == 4 * (2 * n_vars
                              + max(ops.WARPS * n_vars, 32 << bits))
    assert with_table >= points
    assert with_table <= ops.MAX_SMEM


def _parent(enc, seed):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, 2, enc.n_bits).astype(np.int8))


@pytest.mark.parametrize("seed", [0, 1])
def test_table_arithmetic_is_the_plain_version_bitwise(seed):
    """Every child of a 64-variable, 8-bit parent (1,023 rows, some
    masked): each variable's level from the parent's, its complement past
    an odd segment's end or the closed form where the segment cuts it,
    then the term of that level from a table of all 256."""
    obj = tobj.get("rastrigin", n=64)
    enc = obj.encoding
    parent = _parent(enc, seed)
    ids = torch.arange(enc.population)
    valid = ids % 7 != 3
    got = ops.rastrigin_table_values_plain(parent, ids, enc, valid)
    want = ops.child_values_plain(obj, parent, ids, enc, valid)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.isinf(got[~valid]).all()


def test_table_arithmetic_at_the_benchmark_shape():
    """n = 1,000 at 8 bits: the children of the segment tree's top (whole
    variables inside the segment, long odd tails) and a sample of the
    rest, as the engine clips and masks its rows."""
    obj = tobj.get("rastrigin", n=1000)
    enc = obj.encoding
    parent = _parent(enc, 2)
    table = segment_table(enc.n_bits)
    long_rows = np.flatnonzero(table[:, 1] - table[:, 0] > 16)
    ids = torch.as_tensor(np.concatenate([long_rows,
                                          np.arange(0, enc.population, 61),
                                          [enc.population + 5]]))
    valid = ids < enc.population
    got = ops.rastrigin_table_values_plain(parent, ids, enc, valid)
    want = ops.child_values_plain(obj, parent, ids, enc, valid)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
