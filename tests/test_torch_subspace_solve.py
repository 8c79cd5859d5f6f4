"""Solves of the ``subspace-lm:qwen2-1.5b`` tuning problem on the port
against the JAX package (kept apart from ``tests/test_torch_subspace.py``
so that the two files' reference compilations run on separate workers):
``Fused`` with a schedule and ``Batched`` from pinned starts under the
near-tie rule of ``tests/test_torch_strategies.py``, the subspace extras
of a solve, and the scheduler's mixed-wave acceptance case."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solver as jsolver
from repro_torch.core.solver import Batched, Fused, Problem, SolveRequest, solve
from repro_torch.core.tree import entries
from repro_torch.serving import Scheduler
from test_torch_batched import _follows
from test_torch_strategies import _close, assert_same_solve
from test_torch_subspace import MAX_ITERS, NAME, TINY


@pytest.fixture(scope="module")
def tiny_problem():
    return Problem.get(NAME, **TINY)


@pytest.fixture(scope="module")
def tiny_reference():
    return jsolver.Problem.get(NAME, **TINY)


def test_fused_solve_follows_the_reference(tiny_problem, tiny_reference):
    x0 = np.full(4, 0.2, np.float32)
    port = solve(tiny_problem, Fused(max_bits=5), x0=x0,
                 max_iters=MAX_ITERS, device="cpu")
    ref = jsolver.solve(tiny_reference, jsolver.Fused(max_bits=5),
                        x0=jnp.asarray(x0), max_iters=MAX_ITERS)
    assert_same_solve(port, ref, same_bits=False)
    assert port.extras["problem_signature"] == \
        ref.extras["problem_signature"]


def test_batched_solve_follows_the_reference(tiny_problem, tiny_reference):
    x0s = np.random.default_rng(2).uniform(-1, 1, (2, 4)).astype(np.float32)
    port = solve(tiny_problem, Batched(restarts=2), x0=x0s,
                 max_iters=MAX_ITERS, device="cpu")
    ref = jsolver.solve(tiny_reference, jsolver.Batched(restarts=2),
                        x0=jnp.asarray(x0s), max_iters=MAX_ITERS)
    its_p = np.asarray(port.extras["restart_iterations"])
    its_r = np.asarray(ref.extras["restart_iterations"])
    for r in range(2):
        _follows(port.extras["trace"][r][: its_p[r] + 1],
                 ref.extras["trace"][r][: its_r[r] + 1], r)
    assert _close(float(port.best_f), float(ref.best_f))


def test_solve_carries_subspace_extras(tiny_problem):
    res = solve(tiny_problem, Batched(restarts=1), x0=np.zeros((1, 4)),
                max_iters=MAX_ITERS, device="cpu")
    assert res.extras["problem_signature"] == tiny_problem.signature
    assert res.extras["problem_signature"][:2] == ("subspace-lm",
                                                   "qwen2-1.5b")
    assert np.isfinite(float(res.best_f))
    assert (np.diff(res.trace) <= 1e-6).all()
    winner = tiny_problem.materialize(res.best_x)
    leaves = [v.stacked() if hasattr(v, "stacked") else v
              for _, v in entries(winner)]
    assert all(bool(torch.isfinite(x).all()) for x in leaves)


def test_scheduler_serves_tuning_request_in_mixed_wave(tiny_problem):
    """A tuning request served through the Scheduler in a mixed workload
    follows the same trajectory as the direct solve(), bit for bit."""
    direct = solve(tiny_problem, Batched(restarts=1), seed=5,
                   max_iters=MAX_ITERS, device="cpu")
    sched = Scheduler(wave_size=2, device="cpu")
    toy = Problem.get("rastrigin", n=2)
    h_tune = sched.submit(SolveRequest(tiny_problem, seed=5,
                                       max_iters=MAX_ITERS))
    h_toys = [sched.submit(SolveRequest(toy, seed=s, max_iters=8))
              for s in (1, 2)]
    assert sched.drain(timeout_s=120) == 3
    sched.close()
    out = h_tune.result()
    assert float(out.best_f) == float(direct.best_f)
    assert torch.equal(out.best_x, direct.best_x)
    assert out.iterations == direct.iterations
    assert np.array_equal(np.asarray(out.trace), np.asarray(direct.trace))
    assert out.extras["problem_signature"] == tiny_problem.signature
    for h in h_toys:
        assert h.done() and h.error is None
        assert "problem_signature" not in h.result().extras
