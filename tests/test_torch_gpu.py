"""Card-only checks of the CUDA popstep kernel: the kernel vs its plain
PyTorch version on the same CUDA tensors (chip_smoke.py's phases 2-4 as
tests).  Whether a card is present is decided in the ``cuda`` fixture,
so every worker collects the same tests; without a card they skip.

Run them on the card with
``PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py``
(``--noconftest``: the shared conftest imports JAX, which a machine that
only runs the port need not have; this file imports none of it)."""
import numpy as np
import pytest
import torch

from repro_torch.core import objectives
from repro_torch.core.distributed import _shard_plan
from repro_torch.core.solver import Distributed, Problem, solve
from repro_torch.kernels.popstep import ops

pytestmark = pytest.mark.gpu

TOL = 1e-5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the popstep kernel has no CPU mode)")
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


@pytest.mark.parametrize("name", objectives.names())
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
        assert (ops.launches, ops.fold_launches) == (before[0] + 1,
                                                     before[1] + 1)
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
        kv, ki = ops.fold_partials(vals[sl], rows[sl], ids, nb, sentinel=99)
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
    assert ops.fold_launches == ops.launches
    fused = solve(prob, Distributed(inner="fused"), x0=x0, max_iters=16)
    h_p, h_f = pop.extras["history"], fused.extras["history"]
    n = min(len(h_p), len(h_f))
    assert np.allclose(h_p[:n], h_f[:n], rtol=TOL, atol=TOL)
