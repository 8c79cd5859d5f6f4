"""Card-only checks of the CUDA kernels: each kernel vs its plain
PyTorch version on the same CUDA tensors (chip_smoke.py's phases as
tests).  Whether a card is present is decided in the ``cuda`` fixture,
so every worker collects the same tests; without a card they skip.

Run them on the card with
``PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py``
(``--noconftest``: the shared conftest imports JAX, which a machine that
only runs the port need not have; this file imports none of it)."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import objectives
from repro_torch.core.distributed import _shard_plan
from repro_torch.core.encoding import Encoding, pack_bits
from repro_torch.core.population import table_on
from repro_torch.core import dgo
from repro_torch.core.distributed import STALL_CHECK_EVERY
from repro_torch.core.solver import (Clustered, Distributed, Fused, Problem,
                                     Sequential, solve)
from repro_torch.kernels._plain import nan_first_rows
from repro_torch.kernels.fixedpoint import ops as fixedpoint
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.graycode import ops as graycode
from repro_torch.kernels.popmin import ops as popmin
from repro_torch.kernels.popmin.ref import popmin_ref
from repro_torch.kernels.popstep import ops

# the near-tie rule of the schedule phase (host replay of both steps)
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = 1e-5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _atol(name, enc):
    """Long float32 sums in another order: 4 * n * |term| * 2^-23."""
    if name == "rastrigin":
        return max(TOL, 4 * enc.n_vars * (max(abs(enc.lo), enc.hi) ** 2
                                          + 10.0) * 2.0**-23)
    if name == "remote_sensing":
        return max(TOL, 4 * 42 * max(abs(enc.lo), enc.hi) * 2.0**-23)
    return TOL


@pytest.mark.parametrize("name", [n for n in objectives.names()
                                  if ":" not in n])
def test_kernel_matches_plain_version(cuda, name):
    obj = objectives.get(name)
    _check_kernel_vs_plain(cuda, name, obj, obj.encoding)


@pytest.mark.parametrize("bits", [8, 10, 12, 14, 16])
def test_kernel_matches_plain_version_rastrigin9_schedule(cuda, bits):
    """The host-chained main path's problem at each of its resolutions
    (143..287 children; two virtual blocks at 16 bits)."""
    obj = objectives.get("rastrigin", n=9)
    _check_kernel_vs_plain(cuda, "rastrigin", obj,
                           obj.encoding.with_bits(bits))


def _check_kernel_vs_plain(cuda, name, obj, enc):
    plan = _shard_plan(enc.population, 1, 256)
    ids = torch.arange(plan.n_blocks * plan.block, device=cuda)
    valid = ids < plan.pop
    ids = ids.clamp(max=plan.pop - 1)
    parent = torch.as_tensor(np.random.default_rng(0).integers(
        0, 2, enc.n_bits).astype(np.int8), device=cuda)
    atol = _atol(name, enc)
    for vb in (plan.block, None):
        i, v = (ids, valid) if vb else (ids[:plan.pop], valid[:plan.pop])
        before = (ops.launches, ops.fold_launches)
        kv, ki = ops.population_step_ids(obj, parent, i, enc, valid=v,
                                         virtual_block=vb)
        # one launch a step: the fold runs inside it
        assert (ops.launches, ops.fold_launches) == (before[0] + 1,
                                                     before[1])
        pv, pi = ops.population_step_ids_plain(obj, parent, i, enc, valid=v,
                                               virtual_block=vb)
        torch.cuda.synchronize()
        assert np.isclose(float(kv), float(pv), rtol=TOL, atol=atol)
        if int(ki) != int(pi):            # only a near-tie may differ
            vals = ops.child_values_plain(obj, parent, i, enc, v)
            assert np.isclose(float(vals[int(ki)]), float(vals[int(pi)]),
                              rtol=TOL, atol=atol)


def test_fold_matches_plain_rule(cuda):
    nan, inf = float("nan"), float("inf")
    vals = torch.tensor([3.0, 2.0, 2.0, nan, 1.0, nan, 2.0, 5.0, 2.0,
                         inf, inf, inf], device=cuda)
    rows = torch.tensor([5, 1, 0, 9, 8, 4, 3, 6, 2, 10, 11, 7],
                        dtype=torch.int32, device=cuda)
    ids = torch.arange(40, 52, device=cuda)
    for nb, sl in ((4, slice(None)), (1, slice(3, 6)), (1, slice(0, 3))):
        before = (ops.launches, ops.fold_launches)
        kv, ki = ops.fold_partials(vals[sl], rows[sl], ids, nb, sentinel=99)
        # the fold alone is one counted launch of its own kernel
        assert (ops.launches, ops.fold_launches) == (before[0],
                                                     before[1] + 1)
        pv, pi = ops.fold_partials_plain(vals[sl], rows[sl], ids, nb,
                                         sentinel=99)
        assert int(ki) == int(pi)
        assert float(kv) == float(pv) or (np.isnan(float(kv))
                                          and np.isnan(float(pv)))


def test_bound_step_keeps_its_constants(cuda):
    """A bound step owns the device copy of its objective's constants:
    binding many other objectives (and reusing freed memory) after it
    leaves its results unchanged."""
    obj = objectives.get("xor")
    enc = obj.encoding
    ids = torch.arange(enc.population, device=cuda)
    step = ops.prepare_step_ids(obj, ids, enc)
    parent = torch.as_tensor(np.random.default_rng(1).integers(
        0, 2, enc.n_bits).astype(np.int8), device=cuda)
    want = [float(t) for t in step(parent)]
    others = []
    for k in range(65):
        other = objectives.get("shekel")
        ops.prepare_step_ids(other, torch.arange(
            other.encoding.population, device=cuda), other.encoding)
        others.append(torch.full((64,), float(k), device=cuda))
    del others
    torch.cuda.empty_cache()
    scratch = [torch.full((1024,), 1e9, device=cuda) for _ in range(64)]
    assert [float(t) for t in step(parent)] == want
    pv, pi = ops.population_step_ids_plain(obj, parent, ids, enc)
    assert np.isclose(want[0], float(pv), rtol=TOL, atol=TOL)
    del scratch


def test_main_path_goes_through_the_kernel(cuda):
    prob = Problem.get("remote_sensing")
    x0 = np.random.default_rng(0).uniform(-4, 4, 680).astype(np.float32)
    ops.launches = ops.fold_launches = 0
    pop = solve(prob, Distributed(inner="popstep"), x0=x0, max_iters=16)
    assert ops.launches >= 16 and pop.extras["finite"]
    assert ops.fold_launches == 0        # the fold is inside each launch
    fused = solve(prob, Distributed(inner="fused"), x0=x0, max_iters=16)
    h_p, h_f = pop.extras["history"], fused.extras["history"]
    n = min(len(h_p), len(h_f))
    assert np.allclose(h_p[:n], h_f[:n], rtol=TOL, atol=TOL)


def _counted(fn):
    """Run ``fn`` with the popstep counts set to 0 first; returns its
    result, launches and fold launches."""
    ops.launches = ops.fold_launches = 0
    out = fn()
    return out, ops.launches, ops.fold_launches


@pytest.mark.parametrize("name,kw,max_bits", [
    ("rastrigin", {"n": 9}, 16), ("remote_sensing", {}, 8)])
def test_fused_schedule_goes_through_the_kernel(cuda, name, kw, max_bits):
    """One popstep launch a step at every resolution, no fold launch, and
    at most ``STALL_CHECK_EVERY`` predicated launches a resolution; the
    run through the plain tensor step on the card the same step for step
    up to a parting step that is a near-tie
    (``chip_smoke.schedule_runs_match``: a host replay of both steps)."""
    prob = Problem.get(name, **kw)
    enc = prob.encoding
    x0 = np.random.default_rng(1).uniform(enc.lo, enc.hi,
                                          enc.n_vars).astype(np.float32)
    res, n, n_fold = _counted(lambda: solve(
        prob, Fused(max_bits=max_bits), x0=x0, max_iters=16))
    n_res = len(range(enc.bits, max_bits + 1, 2))
    assert n_fold == 0 and res.extras["finite"]
    assert res.iterations <= n <= res.iterations + STALL_CHECK_EVERY * n_res
    cfg = Fused(max_bits=max_bits)._config(prob, 16, max_bits, 2)
    plain = dgo._fused_result(prob.objective, cfg, x0=x0, device=cuda,
                              inner="fused")
    ok, note = chip_smoke.schedule_runs_match(name, prob, cfg, x0, res.trace,
                                              plain.trace, cuda)
    assert ok, note


def test_folded_distributed_equals_host_chaining_on_card(cuda):
    prob = Problem.get("remote_sensing")
    x0 = np.random.default_rng(2).uniform(-4, 4, 680).astype(np.float32)
    res, n, n_fold = _counted(lambda: solve(
        prob, Distributed(max_bits=8), x0=x0, max_iters=16))
    assert n_fold == 0 and res.iterations <= n
    assert n <= res.iterations + STALL_CHECK_EVERY * 3
    host = solve(prob, Distributed(max_bits=8, driver="host"), x0=x0,
                 max_iters=16)
    assert res.extras["history"] == host.extras["history"]
    assert res.extras["bits_resolution"] == host.extras["bits_resolution"]
    assert torch.equal(res.extras["bits"], host.extras["bits"])


def test_clustered_is_its_fused_runs_on_card(cuda):
    prob = Problem.get("rastrigin", n=9)
    starts = prob.random_x0(np.array([0, 3], np.uint32), batch=3)
    res, n, n_fold = _counted(lambda: solve(
        prob, Clustered(n_clusters=3, max_bits=12), x0=starts,
        max_iters=32))
    singles = [solve(prob, Fused(max_bits=12), x0=x, max_iters=32)
               for x in starts]
    assert n_fold == 0 and n >= sum(r.iterations for r in singles)
    assert float(res.best_f) == min(float(r.best_f) for r in singles)
    assert res.extras["evaluations"] == sum(r.extras["evaluations"]
                                            for r in singles)


def test_sequential_and_fused_agree_on_card(cuda):
    prob = Problem.get("rastrigin", n=3)
    x0 = np.asarray([3.1, -2.2, 1.4], np.float32)
    seq = solve(prob, Sequential(max_bits=12), x0=x0)
    fused = solve(prob, Fused(max_bits=12), x0=x0)
    assert abs(float(seq.best_f) - float(fused.best_f)) < 1e-3


def _engine_step(cuda, obj, enc, seed):
    plan = _shard_plan(enc.population, 1, 256)
    ids = torch.arange(plan.n_blocks * plan.block, device=cuda)
    valid = ids < plan.pop
    parent = torch.as_tensor(np.random.default_rng(seed).integers(
        0, 2, enc.n_bits).astype(np.int8), device=cuda)
    return parent, ids.clamp(max=plan.pop - 1), valid, plan.block


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_schedule_steps_match_plain_version(cuda, bits):
    """The remote-sensing MLP's schedule steps from a random parent (values
    of order one): Fused's one run and the folded engine's blocks planned
    at the 16-bit p_max, winner and every child's value."""
    obj = objectives.get("remote_sensing")
    enc = obj.encoding.with_bits(bits)
    parent = torch.as_tensor(np.random.default_rng(bits).integers(
        0, 2, enc.n_bits).astype(np.int8), device=cuda)
    atol = _atol("remote_sensing", enc)
    for _, ids, valid, vb in chip_smoke._geometries(
            enc, cuda, (2 * enc.n_vars * 16 - 1,))[1:]:
        step = ops.prepare_step_ids(obj, ids, enc, valid=valid,
                                    virtual_block=vb)
        kv, ki = step(parent)
        got = step.values
        want = ops.child_values_plain(obj, parent, ids, enc, valid)
        pv, pi = ops.population_step_ids_plain(obj, parent, ids, enc,
                                               valid=valid, virtual_block=vb)
        assert torch.isclose(got, want, rtol=TOL, atol=atol).all()
        assert np.isclose(float(kv), float(pv), rtol=TOL, atol=atol)
        if int(ki) != int(pi):            # only a near-tie may differ
            assert np.isclose(float(want[int(ki)]), float(want[int(pi)]),
                              rtol=TOL, atol=atol)


@pytest.mark.parametrize(
    "name,bits,n", [pytest.param("remote_sensing", 4, None,
                                 id="remote_sensing-4")]
    + [pytest.param("rastrigin", b, 9, id=f"rastrigin-{b}")
       for b in (8, 10, 12, 14, 16)]
    + [pytest.param("rastrigin", 8, 1000, id="rastrigin-8-n1000")])
def test_every_child_value_matches_plain_version(cuda, name, bits, n):
    """The kernel's (K,) value buffer, child by child, against the plain
    version (masked rows +inf in both); rastrigin n=1,000 at 8 bits reads
    its terms from the level table."""
    obj = (objectives.get(name) if name == "remote_sensing"
           else objectives.get(name, n=n))
    enc = obj.encoding.with_bits(bits)
    parent, ids, valid, block = _engine_step(cuda, obj, enc, bits)
    step = ops.prepare_step_ids(obj, ids, enc, valid=valid,
                                virtual_block=block)
    step(parent)
    got = step.values
    want = ops.child_values_plain(obj, parent, ids, enc, valid)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.isclose(got, want, rtol=TOL, atol=_atol(name, enc)).all()


def test_reused_hidden_units_are_bitwise_a_full_evaluation(cuda):
    """Reading the parent's hidden unit where the child's pattern leaves
    its variables alone gives the same bits as recomputing every unit."""
    obj = objectives.get("remote_sensing")
    parent, ids, valid, _ = _engine_step(cuda, obj, obj.encoding, 7)
    reused = ops.child_values(obj, parent, ids, obj.encoding, valid)
    full = ops.child_values(obj, parent, ids, obj.encoding, valid,
                            reuse=False)
    assert torch.equal(reused.view(torch.int32), full.view(torch.int32))


@pytest.mark.parametrize("n", [1000, 64])
def test_term_table_is_bitwise_the_cosine_path(cuda, n):
    """Rastrigin's terms looked up in the block's table of levels give the
    same bits as a precise cosf a term (``reuse=False``), in a one-parent
    launch and in a launch of 4 restarts with one not live."""
    obj = objectives.get("rastrigin", n=n)
    enc = obj.encoding
    parent, ids, valid, block = _engine_step(cuda, obj, enc, n)
    before = ops.table_launches
    table = ops.child_values(obj, parent, ids, enc, valid)
    assert ops.table_launches == before + 1
    cosine = ops.child_values(obj, parent, ids, enc, valid, reuse=False)
    assert ops.table_launches == before + 1
    assert torch.equal(table.view(torch.int32), cosine.view(torch.int32))

    parents = torch.as_tensor(np.random.default_rng(n + 1).integers(
        0, 2, (4, enc.n_bits)).astype(np.int8), device=cuda)
    live = torch.tensor([True, True, False, True], device=cuda)
    steps = [ops._prepare_cuda(obj, ids, enc, valid, ids.shape[0] // block,
                               restarts=4, reuse=reuse)
             for reuse in (True, False)]
    assert [step.table for step in steps] == [True, False]
    (tv, ti), (cv, ci) = (step(parents, live) for step in steps)
    assert torch.equal(steps[0].values[live].view(torch.int32),
                       steps[1].values[live].view(torch.int32))
    assert torch.equal(tv[live].view(torch.int32), cv[live].view(torch.int32))
    assert torch.equal(ti[live], ci[live])


@pytest.mark.parametrize("name", ["remote_sensing", "rastrigin"])
def test_consecutive_launches_give_the_same_step(cuda, name):
    """Each launch leaves the keys, the work counter and the ticket reset
    for the next: a bound step launched again gives the same result."""
    obj = (objectives.get(name) if name == "remote_sensing"
           else objectives.get(name, n=9))
    enc = obj.encoding if name == "remote_sensing" else \
        obj.encoding.with_bits(16)
    parent, ids, valid, block = _engine_step(cuda, obj, enc, 11)
    step = ops.prepare_step_ids(obj, ids, enc, valid=valid,
                                virtual_block=block)
    first = [float(t) for t in step(parent)]
    for _ in range(3):
        assert [float(t) for t in step(parent)] == first
    pv, pi = ops.population_step_ids_plain(obj, parent, ids, enc,
                                           valid=valid, virtual_block=block)
    assert np.isclose(first[0], float(pv), rtol=TOL, atol=_atol(name, enc))


def test_fold_keeps_signed_zeros_and_drops_nan_blocks(cuda):
    """The cross-block rule on its own (``fold_partials``) over crafted
    partials: a -0.0 winner keeps its sign, a NaN block is dropped across
    blocks and is the answer of a single block."""
    nan = float("nan")
    vals = torch.tensor([-0.0, 0.0, 1.0, nan, 2.0, 3.0, 0.0, -0.0, 5.0],
                        device=cuda)
    rows = torch.arange(9, dtype=torch.int32, device=cuda)
    ids = torch.arange(9, device=cuda)
    for nb, nan_wins in ((1, True), (3, False)):
        kv, ki = ops.fold_partials(vals, rows, ids, nb, sentinel=99)
        pv, pi = ops.fold_partials_plain(vals, rows, ids, nb, sentinel=99)
        assert int(ki) == int(pi)
        if nan_wins:       # one virtual block: its NaN is the result
            assert np.isnan(float(kv)) and np.isnan(float(pv))
        else:              # blocks (-0.0, 0), NaN, (0.0, 6): -0.0 wins
            assert float(kv) == float(pv) == 0.0 and int(ki) == 0
            assert np.signbit(float(kv)) and np.signbit(float(pv))


def _bits(shape, seed, dev):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, 2, shape).astype(np.int8), device=dev)


# W even (100: 4 words; 2048: 64) and odd (144: 5; 1100: 35; 2720: 85);
# 12,100 (W = 379) takes a warp's lanes over a span's word pairs more than
# once
@pytest.mark.parametrize("n", [100, 2720, 144, 1100, 2048, 12100])
def test_graycode_kernel_matches_plain_version(cuda, n):
    parent = _bits(n, n, cuda)
    before = graycode.launches
    got = graycode.generate_population_packed(parent)
    assert graycode.launches == before + 1
    table = table_on("table", n, cuda)
    want = graycode.graycode_children_plain(parent, table[:, 0], table[:, 1])
    assert torch.equal(got, want)


def test_graycode_kernel_at_its_shared_memory_budget(cuda):
    """The largest parent the kernel takes (W = MAX_SMEM / 4 words, a
    partial last word), on an odd number of its children."""
    n = 32 * (graycode.MAX_SMEM // 4) - 5
    parent = _bits(n, 5, cuda)
    ids = torch.as_tensor(np.random.default_rng(6).choice(2 * n - 1, 63,
                                                          replace=False))
    table = table_on("table", n, cuda)[ids.to(cuda)]
    before = graycode.launches
    got = graycode.graycode_children(parent, table[:, 0], table[:, 1])
    assert graycode.launches == before + 1
    want = graycode.graycode_children_plain(parent, table[:, 0], table[:, 1])
    assert got.shape == (63, n // 32 + 1) and torch.equal(got, want)


def test_graycode_kernel_takes_an_unaligned_parent(cuda):
    """A parent 1 byte off a 16-byte boundary (the kernel loads 16 bytes
    at a time; the wrapper copies such a parent)."""
    n = 2720
    parent = _bits(n + 1, 7, cuda)[1:]
    assert parent.data_ptr() % 16
    table = table_on("table", n, cuda)
    want = graycode.graycode_children_plain(parent, table[:, 0], table[:, 1])
    assert torch.equal(graycode.generate_population_packed(parent), want)


# widths dividing 32 at 9 vars, whose rows start off 16-byte boundaries,
# straddling fields (7 and 6 bits), rows of 1, 127, 128 and 129 vars around
# a block's step of 128 points, populations past one wave of the card's
# blocks (staged), and rows longer than the kernel stages (13,000 and
# 13,125 words: read in place) (pop; None: the encoding's own)
@pytest.mark.parametrize("n_vars,bits,lo,hi,pop", [
    (680, 4, -4.0, 4.0, None), (5, 32, -3.0, 7.0, None),
    (9, 1, -3.0, 7.0, None), (9, 8, -3.0, 7.0, None),
    (9, 32, -3.0, 7.0, None), (9, 7, -3.0, 7.0, None),
    (8, 6, -3.0, 7.0, None), (9, 16, -3.0, 7.0, 1_000_000),
    (680, 4, -4.0, 4.0, 20_000), (13_000, 32, -3.0, 7.0, 9),
    (60_000, 7, -3.0, 7.0, 9), (1, 7, -3.0, 7.0, None),
    (127, 3, -3.0, 7.0, None), (128, 2, -3.0, 7.0, None),
    (129, 1, -3.0, 7.0, None)])
def test_fixedpoint_kernel_matches_plain_version(cuda, n_vars, bits, lo, hi,
                                                 pop):
    enc = Encoding(n_vars, bits, lo, hi)
    if pop is None:
        words = pack_bits(_bits((enc.population, enc.n_bits), bits, cuda))
    else:
        words = torch.as_tensor(np.random.default_rng(pop).integers(
            0, 2**32, (pop, (enc.n_bits + 31) // 32)), device=cuda)
    before = fixedpoint.launches
    got = fixedpoint.decode_packed(words, enc)
    assert fixedpoint.launches == before + 1
    want = fixedpoint.decode_words_plain(words, enc)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# P = 1..9 (fewer values than one 16-byte load), the packed main path's
# 287 and 5,439, 512 +1 and 8,192 +1 (where the one block takes a wider
# block), the switch from one block to a grid and +-1, 2^20 and 2^24
# (64 MB, more than the L2 holds)
POPMIN_PS = [*range(1, 10), 287, 512, 513, 5439, 8192, 8193,
             popmin.ONE_BLOCK_MAX - 1, popmin.ONE_BLOCK_MAX,
             popmin.ONE_BLOCK_MAX + 1, 2**20, 2**24]


def _popmin_cases(p, cuda):
    """Random values, a NaN at the last index after a smaller value, all
    NaN, all +inf, a 0.0 before a -0.0 (and the reverse), and a three-way
    tie."""
    vals = torch.as_tensor(np.random.default_rng(p).standard_normal(
        p).astype(np.float32), device=cuda)
    cases = {"random": vals}
    last_nan = vals.clone()
    last_nan[p // 2] = -10.0
    last_nan[p - 1] = float("nan")
    cases["last NaN"] = last_nan
    cases["all NaN"] = torch.full_like(vals, float("nan"))
    cases["all +inf"] = torch.full_like(vals, float("inf"))
    if p > 2:
        for label, pair in (("0.0 then -0.0", [0.0, -0.0]),
                            ("-0.0 then 0.0", [-0.0, 0.0])):
            v = vals.abs() + 1.0
            v[[p // 3, p // 2] if p > 5 else [1, 2]] = torch.tensor(
                pair, device=cuda)
            cases[label] = v
        ties = vals.clone()
        ties[[p - 1, p // 2, p // 3]] = -10.0
        cases["ties"] = ties
    return cases


def _check_popmin(v, label):
    """One launch and no fold launch; (value bits, index) equal to the
    plain version's and the oracle's."""
    before = (popmin.launches, popmin.fold_launches)
    kv, ki = popmin.population_min(v)
    assert (popmin.launches, popmin.fold_launches) == (before[0] + 1,
                                                       before[1]), label
    for wv, wi in (popmin.population_min_plain(v), popmin_ref(v)):
        assert int(ki) == int(wi), label
        assert torch.equal(kv.view(torch.int32),
                           wv.to(torch.float32).view(torch.int32)), label


@pytest.mark.parametrize("p", POPMIN_PS)
def test_popmin_kernel_matches_plain_version(cuda, p):
    for label, v in _popmin_cases(p, cuda).items():
        _check_popmin(v, f"P={p} {label}")


@pytest.mark.parametrize("p", [5439, popmin.ONE_BLOCK_MAX + 1, 2**20])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_popmin_kernel_takes_offset_views(cuda, p, k):
    """v[k:] starts off a 16-byte boundary; the minimum in the values
    before the first aligned one, then after the last whole vector."""
    base = torch.as_tensor(np.random.default_rng(k).standard_normal(
        p + k).astype(np.float32), device=cuda)
    for at in (k, p + k - 1):
        v = base.clone()
        v[at] = -10.0
        view = v[k:]
        assert view.data_ptr() % 16 != 0
        _check_popmin(view, f"P={p} v[{k}:] min at {at - k}")


def test_popmin_kernel_on_two_streams(cuda):
    """Grid launches alternated on two streams, each with its own ticket
    and partial slots: every result is its own input's."""
    p = 2**22
    rng = np.random.default_rng(3)
    ins = [torch.as_tensor(rng.standard_normal(p).astype(np.float32),
                           device=cuda) for _ in range(2)]
    want = [(int(popmin_ref(v)[1]), float(popmin_ref(v)[0])) for v in ins]
    assert want[0][0] != want[1][0]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    assert streams[0].cuda_stream != streams[1].cuda_stream
    got = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    for _ in range(50):
        for j, s in enumerate(streams):
            with torch.cuda.stream(s):
                got.append((j, popmin.population_min(ins[j])))
    torch.cuda.synchronize()
    for j, (kv, ki) in got:
        assert (int(ki), float(kv)) == want[j]


@pytest.mark.parametrize("k", [6, 1024])
def test_popmin_fold_kernel_matches_plain_version(cuda, k):
    """The fold alone on crafted partials (NaNs, ties, a -0.0) with
    unordered indices; one count in ``fold_launches`` each."""
    rng = np.random.default_rng(k)
    vals = rng.integers(-5, 5, k).astype(np.float32)
    rows = rng.permutation(3 * k)[:k].astype(np.int32)
    vals[[0, k - 1]] = [-0.0, -5.0]
    cases = (vals, np.where(np.arange(k) % 3 == 1, np.nan, vals))
    for v in cases:
        pv = torch.as_tensor(v, device=cuda)
        pr = torch.as_tensor(rows, device=cuda)
        before = popmin.fold_launches
        kv, ki = popmin.fold_partials(pv, pr)
        assert popmin.fold_launches == before + 1
        wv, wi = nan_first_rows(pv[None], pr.long()[None])
        assert int(ki) == int(wi[0])
        assert torch.equal(kv.view(torch.int32), wv[0].view(torch.int32))


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal,window,dt", [
    (1, 256, 8, 2, 64, True, 0, torch.float32),
    (1, 100, 4, 2, 32, False, 0, torch.float32),
    (2, 300, 12, 1, 128, True, 64, torch.float32),
    (2, 200, 4, 2, 16, True, 0, torch.bfloat16),
])
def test_flash_kernel_matches_plain_version(cuda, b, s, hq, hkv, hd, causal,
                                            window, dt):
    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(b, s, h, hd, generator=g, device=cuda).to(dt)
               for h in (hq, hkv, hkv))
    before = flash.launches
    got = flash.flash_sdpa(q, k, v, causal=causal, window=window)
    assert flash.launches == before + 1 and got.dtype == dt
    plain = flash.flash_sdpa_plain(q, k, v, scale=hd ** -0.5, causal=causal,
                                   window=window)
    oracle = flash_ref.flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window).transpose(1, 2)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    for want in (plain, oracle):
        assert float((got.float() - want.float()).abs().max()) <= tol


def test_flash_kernel_takes_strided_inputs(cuda):
    """A transposed view is made contiguous by the wrapper, not misread."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, 4, 128, 32, generator=g, device=cuda).transpose(1, 2)
    k = torch.randn(2, 2, 128, 32, generator=g, device=cuda).transpose(1, 2)
    got = flash.flash_sdpa(q, k, k)
    want = flash.flash_sdpa_plain(q, k, k, scale=32 ** -0.5)
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("hd", flash.HEAD_DIMS)
@pytest.mark.parametrize("s,hkv,window", [(300, 2, 0), (300, 1, 64),
                                          (77, 4, 0)])
def test_flash_bf16_kernel_matches_plain_version(cuda, hd, s, hkv, window):
    """The tensor-core kernel at every head dim, at S that is no multiple
    of its 128-row tiles, with a window and MQA: within 2e-2 of the plain
    version (P rounded to bf16 on both sides) and of ref.py."""
    g = torch.Generator(device=cuda).manual_seed(hd + s)
    q, k, v = (torch.randn(2, s, h, hd, generator=g, device=cuda).bfloat16()
               for h in (4, hkv, hkv))
    before = flash.launches
    got = flash.flash_sdpa(q, k, v, causal=True, window=window)
    assert flash.launches == before + 1 and got.dtype == torch.bfloat16
    plain = flash.flash_sdpa_plain(q, k, v, scale=hd ** -0.5, causal=True,
                                   window=window)
    oracle = flash_ref.flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=window).transpose(1, 2)
    for want in (plain, oracle):
        assert float((got.float() - want.float()).abs().max()) <= 2e-2


def test_flash_bf16_kernel_takes_strided_inputs(cuda):
    """A transposed bf16 view is made contiguous by the wrapper before its
    tensor maps are encoded, not misread."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(2, 4, 200, 64, generator=g,
                    device=cuda).bfloat16().transpose(1, 2)
    k = torch.randn(2, 2, 200, 64, generator=g,
                    device=cuda).bfloat16().transpose(1, 2)
    got = flash.flash_sdpa(q, k, k)
    want = flash.flash_sdpa_plain(q, k, k, scale=64 ** -0.5)
    assert float((got.float() - want.float()).abs().max()) <= 2e-2


def test_lm_prefill_routes_every_layer_through_the_kernel(cuda):
    """reduced(qwen2-1.5b) at S = 160: one launch per layer, and the same
    logits as the chunked plain attention on the card."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import init_model, lm_prefill

    arch = dataclasses.replace(reduced(get_arch("qwen2-1.5b")),
                               use_flash_attention=True)
    params = init_model(arch, torch.Generator(device=cuda).manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, arch.vocab_size, (2, 160)), device=cuda)
    flash.launches = 0
    got, _ = lm_prefill(params, arch, {"tokens": toks}, 170,
                        dtype=torch.float32)
    assert flash.launches == arch.n_layers
    want, _ = lm_prefill(params, dataclasses.replace(
        arch, use_flash_attention=False), {"tokens": toks}, 170,
        dtype=torch.float32)
    assert flash.launches == arch.n_layers
    assert float((got - want).abs().max()) <= 2e-4


@pytest.mark.parametrize("name,kw,s,calls", [
    ("codeqwen1.5-7b", {}, 160, 4),
    ("granite-34b", {}, 160, 4),
    ("gemma3-27b", {"n_layers": 6}, 160, 1),
    ("whisper-medium", {"n_frames": 200}, 130, 6),
    ("phi-3-vision-4.2b", {"head_dim": 96}, 128, 4)])
def test_zoo_prefill_routes_global_layers_through_the_kernel(cuda, name, kw,
                                                             s, calls):
    """reduced() of the zoo beyond qwen2, the flash route on: one launch
    for every global full-sequence self-attention (gemma's sixth layer,
    whisper's two encoder layers over 200 frames, phi-3 at hd 96 after
    its 4 image tokens), and the same logits as the chunked plain
    attention on the card, prefill and two decode steps."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.serve import frontend_inputs
    from repro_torch.models import init_model, lm_decode, lm_prefill

    arch = dataclasses.replace(reduced(get_arch(name)), **kw,
                               use_flash_attention=True)
    params = init_model(arch, torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, arch.vocab_size, (2, s),
                                     generator=gen),
             **frontend_inputs(arch, 2, gen)}
    batch = {k: v.to(cuda) for k, v in batch.items()}
    outs = []
    for flash_on in (True, False):
        a = dataclasses.replace(arch, use_flash_attention=flash_on)
        flash.launches = 0
        logits, cache = lm_prefill(params, a, batch, s + 2,
                                   dtype=torch.float32)
        assert flash.launches == (calls if flash_on else 0)
        steps = [logits]
        for _ in range(2):
            logits, cache = lm_decode(params, a, logits.argmax(-1), cache,
                                      dtype=torch.float32)
            steps.append(logits)
        outs.append(torch.stack(steps))
    assert float((outs[0] - outs[1]).abs().max()) <= 2e-4


@pytest.mark.parametrize("name,s,calls", [
    ("xlstm-125m", 40, 0),
    ("zamba2-1.2b", 160, 2),       # the shared block's two applications
    ("deepseek-v2-236b", 40, 0),
    ("deepseek-v3-671b", 40, 0)])
def test_zoo2_reduced_serves_on_card_as_on_cpu(cuda, name, s, calls):
    """reduced() of xLSTM, zamba2 and the two deepseek models (the
    reference's weights from one key on both devices), served two waves
    of 2 prompts and 4 tokens through ``serve_lm``, the flash route on:
    the card's prefill logits within 2e-4 x max(1, max |logit|) of the
    CPU's, greedy tokens equal but at near-ties, and one kernel launch
    for each application of zamba2's shared block a prefill, none for
    the others."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import prng
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import init_model

    arch = dataclasses.replace(reduced(get_arch(name)),
                               use_flash_attention=True)
    runs = {}
    for dev in (torch.device("cpu"), cuda):
        flash.launches = 0
        runs[dev.type] = serve_lm(
            arch, batch=2, prompt_len=s, gen_len=4, waves=2, seed=1,
            device=dev, params=init_model(arch, prng.PRNGKey(0), device=dev))
        torch.cuda.synchronize()
        launches = flash.launches
    assert launches == 2 * calls
    cpu, card = runs["cpu"], runs["cuda"]
    for w in range(2):
        want, got = cpu.logits[w], card.logits[w].cpu()
        bar = 2e-4 * max(1.0, float(want[0].abs().max()))
        assert float((got[0] - want[0]).abs().max()) <= bar
        chip_smoke.tokens_match(card.tokens[w].cpu().numpy(),
                                cpu.tokens[w].numpy(), want.numpy())


# ---------------------------------------------------------------------------
# the R-restart popstep launch, meshes and the batched engine on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,live", [(1, [True]), (3, [True, False, True]),
                                    (8, [True] * 5 + [False, True, False])])
def test_restart_launch_matches_plain(cuda, r, live):
    """One launch for R remote-sensing parents (some not live) vs the
    one-parent plain step on each live parent; each live result also
    bitwise a one-parent launch's."""
    obj = objectives.get("remote_sensing")
    par = torch.as_tensor(np.random.default_rng(r).integers(
        0, 2, (r, obj.encoding.n_bits)).astype(np.int8), device=cuda)
    chip_smoke.check_restarts("remote_sensing", "remote_sensing", obj,
                              obj.encoding, par, live, cuda)


@pytest.mark.parametrize("phase", range(8))
def test_restart_launch_on_a_masked_mesh(cuda, phase):
    """rastrigin n=9 at 16 bits on 8 one-block shards, two dead, at each
    rotation phase."""
    obj = objectives.get("rastrigin", n=9)
    enc = obj.encoding.with_bits(16)
    par = torch.as_tensor(np.random.default_rng(phase).integers(
        0, 2, (8, enc.n_bits)).astype(np.int8), device=cuda)
    chip_smoke.check_restarts("rastrigin n=9", "rastrigin", obj, enc, par,
                              [True] * 8, cuda, n_shards=8, dead=(1, 4),
                              phase=phase)


@pytest.mark.parametrize("shards,vb", [(8, 256), (2, 23)])
def test_restart_launch_nan_child_across_shards(cuda, shards, vb):
    """A NaN child: a shard of one block makes the step NaN, a shard of
    several drops the block (the plain rule, held by check_restarts)."""
    from repro_torch.core.encoding import encode

    xor = chip_smoke._xor_with_nan_sample()
    safe = torch.as_tensor([4, 4, -4, -4, 0.1, 0.1, 1, 1],
                           dtype=torch.float32, device=cuda)
    par = torch.stack([encode(safe, xor.encoding)] * 3)
    chip_smoke.check_restarts("xor nan", "xor", xor, xor.encoding, par,
                              [True, False, True], cuda, n_shards=shards,
                              vb=vb)


def test_bound_step_refuses_a_second_stream(cuda):
    obj = objectives.get("rastrigin", n=9)
    enc = obj.encoding
    ids = torch.arange(enc.population, device=cuda)
    step = ops.prepare_step_ids(obj, ids, enc, restarts=2)
    par = torch.zeros((2, enc.n_bits), dtype=torch.int8, device=cuda)
    step(par)
    other = torch.cuda.Stream(cuda)
    with torch.cuda.stream(other):
        with pytest.raises(RuntimeError, match="bind another step"):
            step(par)
    with pytest.raises(ValueError, match="torch.bool"):
        step(par, torch.ones(2, dtype=torch.int32, device=cuda))


def test_solve_many_slots_equal_per_request_solves_on_card(cuda):
    """Waves of 8 (the last partial) on the card: one popstep launch per
    batched step, each slot bit for bit its per-request solve."""
    from repro_torch.core.solver import Batched, SolveRequest, solve_many

    prob = Problem.get("rastrigin", n=9)
    reqs = [SolveRequest(prob, seed=i, max_iters=(40, 12, 30)[i % 3])
            for i in range(11)]
    ops.launches = ops.fold_launches = 0
    outs = solve_many(reqs, pad_to=8)
    torch.cuda.synchronize()
    n, n_fold = ops.launches, ops.fold_launches
    assert n > 0 and n_fold == 0
    assert n <= max(o.iterations for o in outs[:8]) + \
        max(o.iterations for o in outs[8:]) + 2 * STALL_CHECK_EVERY
    for req, out in zip(reqs, outs):
        one = solve(prob, Batched(restarts=1), seed=req.seed,
                    max_iters=req.max_iters)
        assert chip_smoke._bitwise(out, one), req


def test_masked_mesh_device_driver_equals_host_driver(cuda):
    prob = Problem.get("rastrigin", n=9)
    mask = [True, False, True, True, False, True, True, True]
    x0 = np.random.default_rng(4).uniform(-5.12, 5.12, 9).astype(np.float32)
    runs = [solve(prob, Distributed(mesh=8, quorum_mask=mask, driver=d),
                  x0=x0, max_iters=64) for d in ("device", "host")]
    assert runs[0].extras["history"] == runs[1].extras["history"]
    assert float(runs[0].best_f) < runs[0].extras["history"][0]


# ---------------------------------------------------------------------------
# the train path and subspace DGO on the card (no kernel: the card's
# PyTorch against the CPU's)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7,), (3, 1000, 7), (5_000_001,)])
def test_normal_twin_on_card_equals_numpy_twin(cuda, shape):
    """The device twin's draws are the numpy twin's bit for bit on the
    card too (float64 log1p and sqrt, each rounded once to float32)."""
    from repro_torch.core import prng

    key = prng.fold_in(prng.PRNGKey(3), 17)
    got = prng.normal_torch(key, shape, cuda).cpu().numpy()
    assert np.array_equal(got.view(np.int32),
                          prng.normal(key, shape).view(np.int32))
    got = prng.uniform_torch(key, shape, -5.12, 5.12, cuda).cpu().numpy()
    assert np.array_equal(got.view(np.int32), prng.uniform(
        key, shape, -5.12, 5.12).view(np.int32))


def _reduced_batch(b=2, s=20):
    from repro_torch.data import lm_synthetic_batch
    from repro_torch.core import prng

    tokens, labels = lm_synthetic_batch(prng.PRNGKey(5), b, s, 256)
    return {"tokens": torch.from_numpy(tokens).long(),
            "labels": torch.from_numpy(labels).long()}


def test_lm_loss_and_gradients_on_card_match_cpu(cuda):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import prng
    from repro_torch.core.tree import entries, tree_map
    from repro_torch.models.lm import init_model, lm_loss

    arch = reduced(get_arch("qwen2-1.5b"))
    grads = {}
    for dev in ("cpu", cuda):
        params = init_model(arch, prng.PRNGKey(0), device=dev).tree()
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        batch = {k: v.to(dev) for k, v in _reduced_batch().items()}
        loss = lm_loss(live, arch, batch, dtype=torch.float32)
        loss.backward()
        grads[str(dev)] = (float(loss.detach()), {
            k: (g.stacked() if hasattr(g, "stacked") else g).cpu().numpy()
            for k, g in entries(tree_map(lambda p: p.grad, live))})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = grads["cpu"], grads["cuda"]
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)
    for k, g in g_cpu.items():
        assert np.abs(g_gpu[k] - g).max() <= 1e-4 * np.abs(g).max(), k


def test_subspace_objective_on_card_matches_cpu(cuda):
    """70 children across the search box (losses ~50-135: z = +-1 moves
    the weights far) on the card and on the CPU: a whole model's float32
    in two summation orders.  Both computations are deterministic: the
    maximum was 1.004e-05 relative in each of two runs on an NVIDIA H100
    80GB HBM3 at 700 W, so the bar is twice that."""
    z = torch.rand(70, 24, generator=torch.Generator().manual_seed(0)) * 2 - 1
    obj = objectives.get("subspace-lm:qwen2-1.5b")
    want = obj.fn(z).numpy()
    got = obj.fn(z.to(cuda)).cpu().numpy()
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    print(f"subspace objective, card vs CPU: max relative {rel:.3e}")
    assert rel <= 2e-5, rel


def test_subspace_problem_takes_the_plain_step_on_card(cuda):
    """A subspace objective has no device form: under Fused, Batched and
    solve_many on the card it takes the plain tensor step (no popstep
    launch) and does not raise."""
    from repro_torch.core.solver import Batched, SolveRequest, solve_many

    prob = Problem.get("subspace-lm:qwen2-1.5b", d=4, bits=3, layers=1)
    ops.launches = ops.fold_launches = 0
    runs = [solve(prob, Fused(max_bits=5), seed=1, max_iters=4),
            solve(prob, Batched(restarts=3), seed=2, max_iters=4)]
    runs += solve_many([SolveRequest(prob, seed=s, max_iters=4)
                        for s in range(3)], pad_to=4)
    torch.cuda.synchronize()
    assert ops.launches == ops.fold_launches == 0
    assert all(np.isfinite(float(r.best_f)) for r in runs)
    assert all(r.extras["problem_signature"] == prob.signature
               for r in runs)


def test_trainer_on_card_follows_cpu(cuda, tmp_path):
    """Three reduced steps on the card and on the CPU from the same seed:
    the first loss within 1e-5, the others within 1e-3 (AdamW's first
    steps amplify rounding, tests/test_torch_train.py); the card's
    checkpoint restores bit for bit."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core.tree import entries
    from repro_torch.launch import train

    argv = ["--arch", "qwen2-1.5b", "--reduced", "--steps", "3",
            "--global-batch", "2", "--seq-len", "16", "--ckpt-every", "3"]
    runs = {}
    for dev in ("cpu", "cuda"):
        args = train.build_argparser().parse_args(
            argv + ["--ckpt-dir", str(tmp_path / dev)])
        runs[dev] = train.run_training(args, device=dev, keep_state=True)
    l_cpu, l_gpu = (np.asarray(runs[d]["losses"]) for d in ("cpu", "cuda"))
    rel = np.abs(l_gpu - l_cpu) / l_cpu
    assert rel[0] <= 1e-5 and rel.max() <= 1e-3, rel
    state = runs["cuda"]["state"]
    back = restore_checkpoint(tmp_path / "cuda", 3, state)
    for (k, a), (_, b) in zip(entries(back), entries(state)):
        a = a.stacked() if hasattr(a, "stacked") else a
        b = b.stacked() if hasattr(b, "stacked") else b
        assert a.device.type == "cuda" and torch.equal(a, b), k


# ---------------------------------------------------------------------------
# the launch layer on the card (chip_smoke.py phase 12 at small sizes)
# ---------------------------------------------------------------------------

def _run_py(args, timeout=600):
    import json
    import os
    import subprocess
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable] + args, capture_output=True,
                         text=True, cwd=root, timeout=timeout,
                         env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]


_FLEET_ON_CARD = """
import json, os
from repro_torch.launch.launcher import maybe_initialize_from_env
maybe_initialize_from_env()
from repro_torch.core.distributed import fleet
from repro_torch.core.solver import Distributed, solve
from repro_torch.kernels.popstep import ops
ops.launches = 0
r = solve("rastrigin", Distributed(), seed=0, max_iters=32)
fl = fleet()
os.write(1, (json.dumps({"rank": fl[0] if fl else 0,
    "history": [float(v) for v in r.extras["history"]],
    "launches": ops.launches}) + "\\n").encode())
"""


def test_fleet_on_card_equals_one_process(cuda):
    """12a at rastrigin n=2: a fleet of 2 processes x 4 shards, each
    stepping its shards through popstep on the one card and gathering the
    (value, id) pairs over gloo, takes one 8-shard process's history."""
    launcher = ["-m", "repro_torch.launch.launcher"]
    single = _run_py(launcher + ["--devices", "8", "--", sys.executable,
                                 "-c", _FLEET_ON_CARD])
    two = _run_py(launcher + ["--processes", "2", "--devices", "4", "--",
                              sys.executable, "-c", _FLEET_ON_CARD])
    assert len(two) == 2
    for row in two:
        assert row["history"] == single[0]["history"]
        assert row["launches"] >= len(row["history"]) - 1


_STEPS_ON_CARD = """
import dataclasses, json
import numpy as np, torch
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.launch.mesh import ensure_process_group, make_host_mesh
from repro_torch.launch.steps import build_cell, place
from repro_torch.models import init_model, lm_loss
from repro_torch.optim.gradient import adamw_init
dev = torch.device("cuda")
ensure_process_group(dev)
mesh = make_host_mesh(model=1)
arch = dataclasses.replace(reduced(get_arch("qwen2-1.5b")),
                           use_flash_attention=True)
params = init_model(arch, torch.Generator(device=dev).manual_seed(0),
                    torch.float32).tree()
cell = build_cell(arch, ShapeSpec("t", 64, 4, "train"), mesh,
                  dtype=torch.float32)
toks = torch.randint(0, arch.vocab_size, (1, 4, 64), device=dev,
                     dtype=torch.int32)
batch = {"tokens": toks, "labels": torch.roll(toks, -1, -1)}
with torch.no_grad():
    want = float(lm_loss(params, arch, {"tokens": toks[0].long(),
                 "labels": batch["labels"][0].long()}, dtype=torch.float32))
_, _, loss = cell.step(place(params, cell.in_shardings[0]),
                       place(adamw_init(params), cell.in_shardings[1]),
                       place(batch, cell.in_shardings[2]))
pre = build_cell(arch, ShapeSpec("p", 256, 2, "prefill"), mesh,
                 dtype=torch.float32)
flash.launches = 0
logits, _ = pre.step(place(params, pre.in_shardings[0]),
                     place({"tokens": toks[0, :2].repeat(1, 4)},
                           pre.in_shardings[1]))
print(json.dumps({"loss": float(loss), "want": want,
                  "flash": flash.launches, "layers": arch.n_layers,
                  "finite": bool(logits.to_local().isfinite().all())}))
"""


def test_build_cell_steps_on_a_one_rank_nccl_mesh(cuda):
    """12b at reduced() width: the train step's loss is lm_loss's, and
    the prefill step routes every layer through the flash kernel."""
    got = _run_py(["-c", _STEPS_ON_CARD])[-1]
    assert abs(got["loss"] - got["want"]) <= 1e-6 * abs(got["want"])
    assert got["flash"] == got["layers"] and got["finite"]


_MESH_DEFAULT = """
import json, torch
import torch.distributed as dist
from repro_torch.launch.mesh import make_host_mesh, replicate_to_mesh
mesh = make_host_mesh()
x = replicate_to_mesh(torch.arange(4.0), mesh)
print(json.dumps({"type": mesh.device_type, "shape": list(mesh.mesh.shape),
                  "backend": str(dist.get_backend()),
                  "on": x.to_local().device.type,
                  "sum": float(x.full_tensor().sum())}))
"""


def test_host_mesh_defaults_to_the_card(cuda):
    """``make_host_mesh()`` with no arguments: a (1, 1) mesh on the card
    over NCCL, its DTensors on the card."""
    got = _run_py(["-c", _MESH_DEFAULT])[-1]
    assert got["type"] == "cuda" and got["shape"] == [1, 1]
    assert "nccl" in got["backend"] and got["on"] == "cuda"
    assert got["sum"] == 6.0


_SHARDS_ON_CARD = """
import json, sys
import torch.distributed as dist
from repro_torch.launch import train
args = train.build_argparser().parse_args(ARGV)
try:
    out = train.run_training(args)
    row = {"losses": out["losses"]}
except ValueError as e:
    row = {"error": str(e)}
if dist.is_initialized():
    row.update(rank=dist.get_rank(), backend=str(dist.get_backend()))
print(json.dumps(row))
"""


def _shards_argv(tmp_path, k):
    return ["--arch", "qwen2-1.5b", "--reduced", "--steps", "3",
            "--global-batch", "4", "--seq-len", "32", "--ckpt-every", "3",
            "--ckpt-dir", str(tmp_path / f"k{k}"), "--model-shards", str(k)]


def test_model_shards_on_one_shared_card_raise(cuda, tmp_path):
    """A fleet of 2 on one GPU is a gloo group: ``--model-shards 2`` on
    the card raises the ValueError that names it."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("every rank has a GPU of its own here")
    code = _SHARDS_ON_CARD.replace("ARGV", repr(_shards_argv(tmp_path, 2)))
    rows = _run_py(["-m", "repro_torch.launch.launcher", "--processes", "2",
                    "--", sys.executable, "-c", code])
    assert len(rows) == 2
    assert all("gloo" in r.get("error", "") for r in rows)


def test_model_shards_train_on_the_cards(cuda, tmp_path):
    """A fleet of 2 with a GPU each joins NCCL and trains ``--model-shards
    2`` on the cards, with the losses of one process on one card (the
    train bars)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs: one a rank")
    one = _run_py(["-c", _SHARDS_ON_CARD.replace("ARGV", repr(
        _shards_argv(tmp_path, 1)))])[-1]
    code = _SHARDS_ON_CARD.replace("ARGV", repr(_shards_argv(tmp_path, 2)))
    rows = _run_py(["-m", "repro_torch.launch.launcher", "--processes", "2",
                    "--", sys.executable, "-c", code])
    assert len(rows) == 2
    want = np.asarray(one["losses"])
    for r in rows:
        assert "nccl" in r["backend"]
        got = np.asarray(r["losses"])
        assert np.isclose(got[0], want[0], rtol=1e-6, atol=0)
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3, atol=0)


def test_dgo_train_step_on_card_follows_cpu(cuda):
    """12c at the reference test's size: the regression model's 10 steps
    on the card take the CPU's bits, values within 1e-5."""
    from repro_torch.core import prng
    from repro_torch.core.encoding import Encoding, decode, encode
    from repro_torch.core.subspace import apply_subspace, make_dgo_train_step

    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    ys = xs @ torch.from_numpy(rng.standard_normal((8, 1)).astype(
        np.float32))
    enc = Encoding(n_vars=8, bits=6, lo=-2.0, hi=2.0)
    key = prng.PRNGKey(7)

    def loss(p, b):
        return torch.mean((b[0] @ p["w"] - b[1]) ** 2)

    runs = []
    for dev in (torch.device("cpu"), cuda):
        w0 = {"w": torch.zeros((8, 1), device=dev)}
        data = (xs.to(dev), ys.to(dev))
        step = make_dgo_train_step(loss, enc, None, alpha=4.0)
        bits = encode(torch.zeros(8, device=dev), enc)
        val = loss(apply_subspace(w0, decode(bits, enc), key, 4.0), data)
        hist = []
        for _ in range(10):
            bits, val, _ = step(w0, data, bits, val, key)
            hist.append((bits.cpu().tolist(), float(val)))
        runs.append(hist)
    for (cb, cv), (gb, gv) in zip(*runs):
        assert cb == gb
        assert abs(cv - gv) <= 1e-5 * max(abs(cv), 1e-30)
