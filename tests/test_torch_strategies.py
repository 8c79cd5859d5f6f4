"""The single-problem strategies of the PyTorch port (``Sequential``,
``Fused``, ``Clustered``, and ``Distributed`` with a schedule) vs the JAX
package's, on the CPU: the reference's strategy-parity problems from its
pinned starts, seeded starts, the extras contracts, NaN rules and both
callable conventions.

Runs are held to the reference's under the near-tie rule
(``assert_same_solve``: that of ``tests/test_torch_solver.py``, where a
schedule's runs may also part mid-run at a near-tie), applied to the
sequence each strategy reports step by step: ``history`` for
distributed, ``raw_trace`` for sequential, ``trace`` (best so far) for
fused and clustered."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dgo as jdgo
from repro.core import solver as jsolver
from repro.core.encoding import Encoding as JEnc
from repro_torch.core import dgo as tdgo
from repro_torch.core import prng
from repro_torch.core import solver as tsolver
from repro_torch.core.encoding import Encoding as TEnc
from test_torch_solver import _nan_problems, near_tie_step

MAX_BITS = 12
MAX_ITERS = 64
PARITY = [("quadratic", 3, [4.0, -3.0, 6.5]), ("rastrigin", 2, [3.1, -2.2])]
CONTRACTS = {
    "sequential": {"bits", "evaluations", "raw_trace", "finite"},
    "fused": {"bits", "evaluations", "finite"},
    "clustered": {"bits", "evaluations", "cluster_values", "winner",
                  "finite"},
    "distributed": {"bits", "bits_resolution", "history", "schedule",
                    "finite"},
}


def _strategies(pkg):
    """The reference test's strategies (``tests/test_solver.py``), the
    multi-start one with its start duplicated."""
    d = dict(max_bits=MAX_BITS)
    mesh = {"mesh": 1} if pkg is jsolver else {}
    return {
        "sequential": (pkg.Sequential(**d), False),
        "fused": (pkg.Fused(**d), False),
        "fused-bucketed": (pkg.Fused(bucketed=True, **d), False),
        "clustered": (pkg.Clustered(n_clusters=2, **d), True),
        "distributed-device": (pkg.Distributed(driver="device", **mesh, **d),
                               False),
        "distributed-host": (pkg.Distributed(driver="host", **mesh, **d),
                             False),
    }


def _steps(res):
    """The per-step sequence a strategy reports."""
    if "history" in res.extras:
        return res.extras["history"]
    if "raw_trace" in res.extras:
        return res.extras["raw_trace"]
    return res.trace


def _close(a, b):
    return np.isclose(a, b, rtol=1e-5, atol=1e-5)


def _plateaus(h):
    """The values a run moves through: each step within the bar of the
    last kept value dropped (a stall's repeat, or an improvement smaller
    than the bar, which one package may see and the other not)."""
    out = [h[0]]
    for v in h[1:]:
        if not _close(v, out[-1]):
            out.append(v)
    return np.asarray(out)


def assert_same_solve(port, ref, same_bits=True):
    """The near-tie rule for whole schedules.  Step for step within the
    bar: then the counts, the best value, the evaluations and the bits
    agree.  Otherwise the runs may part only at a near-tie: one package
    takes a step the other does not, whose improvement is within the bar
    (at 16 bits or near flat ground, below float32 rounding), and then
    goes on one step apart; so the values they move through (steps within
    the bar of the last one dropped) must agree one for one, and so must
    the best value.  ``same_bits=False`` where two children of equal value
    (rastrigin's mirror points) may be chosen differently."""
    assert set(port.extras) == set(ref.extras)
    h_p = np.asarray(_steps(port), np.float64)
    h_r = np.asarray(_steps(ref), np.float64)
    n = min(len(h_p), len(h_r))
    if len(h_p) != len(h_r) or not _close(h_p[:n], h_r[:n]).all():
        p_p, p_r = _plateaus(h_p), _plateaus(h_r)
        assert len(p_p) == len(p_r) and _close(p_p, p_r).all(), (
            f"the runs part beyond a near-tie: {p_p} vs {p_r}")
        tiny = [np.any((np.diff(h) < 0) & _close(h[1:], h[:-1]))
                for h in (h_p, h_r)]
        assert any(tiny), "the runs part without a step within the bar"
        assert _close(float(port.best_f), float(ref.best_f))
        return "near-tie"
    assert port.iterations == ref.iterations
    np.testing.assert_allclose(port.trace, ref.trace, rtol=1e-5, atol=1e-5)
    assert _close(float(port.best_f), float(ref.best_f))
    for key in ("evaluations", "winner", "bits_resolution", "schedule"):
        if key in ref.extras:
            assert port.extras[key] == ref.extras[key], key
    if same_bits:
        assert np.array_equal(np.asarray(port.extras["bits"]),
                              np.asarray(ref.extras["bits"]))
    return None


def test_near_tie_rule_for_schedules():
    class R:
        def __init__(self, h, best):
            self.extras = {"raw_trace": np.asarray(h)}
            self.best_f, self.iterations, self.trace = best, len(h) - 1, h

    # one package sees a step below the bar mid-run, then the runs go on
    # one step apart
    assert assert_same_solve(R([9.0, 5.0, 2.000004, 2.0, 1.0, 1.0], 1.0),
                             R([9.0, 5.0, 2.000004, 1.0, 1.0], 1.0)) \
        == "near-tie"
    with pytest.raises(AssertionError, match="beyond a near-tie"):
        assert_same_solve(R([9.0, 5.0, 2.0, 1.5, 1.5], 1.5),
                          R([9.0, 5.0, 2.0, 1.0, 1.0], 1.0))
    with pytest.raises(AssertionError, match="without a step"):
        assert_same_solve(R([9.0, 5.0, 2.0, 2.0, 2.0], 2.0),
                          R([9.0, 5.0, 2.0, 2.0], 2.0))


@pytest.mark.parametrize("strategy", list(_strategies(tsolver)))
@pytest.mark.parametrize("pname,n,x0", PARITY, ids=[p[0] for p in PARITY])
def test_strategy_parity(pname, n, x0, strategy):
    """The reference's ``test_strategy_parity`` problems under each
    strategy, port vs reference; and the reference's own check, every
    strategy within 1e-3 of the others (here: of the reference's fused
    result)."""
    x0 = np.asarray(x0, np.float32)
    t_strat, dup = _strategies(tsolver)[strategy]
    j_strat, _ = _strategies(jsolver)[strategy]
    start = np.stack([x0, x0]) if dup else x0
    ref = jsolver.solve(jsolver.Problem.get(pname, n=n), j_strat,
                        x0=jnp.asarray(start), max_iters=MAX_ITERS)
    port = tsolver.solve(tsolver.Problem.get(pname, n=n), t_strat, x0=start,
                         max_iters=MAX_ITERS, device="cpu")
    assert set(port.extras) == CONTRACTS[t_strat.name]
    assert port.iterations > 0 and tuple(port.best_x.shape) == (n,)
    assert (np.diff(port.trace) <= 1e-6).all()
    assert_same_solve(port, ref)
    fused = jsolver.solve(jsolver.Problem.get(pname, n=n),
                          jsolver.Fused(max_bits=MAX_BITS),
                          x0=jnp.asarray(x0), max_iters=MAX_ITERS)
    assert abs(float(port.best_f) - float(fused.best_f)) < 1e-3


@pytest.mark.parametrize("pname,n,start", [
    ("rastrigin", 2, (3.1, -2.2)),
    ("ackley", 5, (2.0, -4.0, 1.0, 0.5, -3.0)),
    ("quadratic", 9, (5.0,) * 9),
])
def test_fused_bucketed_equals_unbucketed(pname, n, start):
    """The reference's bucketed-engine test at its shapes: bitwise the
    same result, and the reference's own result under the near-tie
    rule."""
    prob = tsolver.Problem.get(pname, n=n)
    prob = prob.replace(encoding=prob.encoding.with_bits(5))
    x0 = np.asarray(start, np.float32)
    a = tsolver.solve(prob, tsolver.Fused(max_bits=13), x0=x0,
                      max_iters=MAX_ITERS, device="cpu")
    b = tsolver.solve(prob, tsolver.Fused(max_bits=13, bucketed=True),
                      x0=x0, max_iters=MAX_ITERS, device="cpu")
    assert float(a.best_f) == float(b.best_f)
    assert torch.equal(a.best_x, b.best_x)
    assert np.array_equal(a.trace, b.trace)
    assert torch.equal(a.extras["bits"], b.extras["bits"])
    assert a.extras["evaluations"] == b.extras["evaluations"]
    jprob = jsolver.Problem.get(pname, n=n)
    jprob = jprob.replace(encoding=jprob.encoding.with_bits(5))
    ref = jsolver.solve(jprob, jsolver.Fused(max_bits=13, bucketed=True),
                        x0=jnp.asarray(x0), max_iters=MAX_ITERS)
    assert_same_solve(b, ref)


def test_bucket_split_and_validation():
    enc = TEnc(2, 3, -10.0, 10.0)
    obj = tsolver.Problem.get("quadratic", n=2).objective

    def cfg(bits, max_bits):
        return tdgo.DGOConfig(encoding=enc.with_bits(bits),
                              max_bits=max_bits, max_iters_per_resolution=8)

    assert tdgo.bucket_split(cfg(3, 11)) == 2
    assert tdgo.bucket_split(cfg(7, 11)) == 0
    for bad in (0, 5, -1):
        with pytest.raises(ValueError, match="n_coarse"):
            tdgo.make_fused_engine_bucketed(obj, cfg(3, 11), n_coarse=bad,
                                            device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("strategy", ["fused", "distributed"])
def test_seeded_solve_starts_at_the_references_x0(seed, strategy):
    """``seed=`` draws the reference's ``x0`` bit for bit through the
    twin: the seeded solve is the solve pinned at the reference's start,
    and the reference's seeded solve under the near-tie rule."""
    jp = jsolver.Problem.get("rastrigin", n=3)
    tp = tsolver.Problem.get("rastrigin", n=3)
    x0_ref = np.asarray(jp.random_x0(jax.random.PRNGKey(seed)))
    x0 = tp.random_x0(prng.PRNGKey(seed))
    assert np.array_equal(x0.view(np.int32), x0_ref.view(np.int32))
    strat = {"fused": (tsolver.Fused(max_bits=10), jsolver.Fused(max_bits=10)),
             "distributed": (tsolver.Distributed(),
                             jsolver.Distributed(mesh=1))}[strategy]
    seeded = tsolver.solve(tp, strat[0], seed=seed, max_iters=MAX_ITERS,
                           device="cpu")
    pinned = tsolver.solve(tp, strat[0], x0=x0_ref, max_iters=MAX_ITERS,
                           device="cpu")
    assert np.array_equal(seeded.trace, pinned.trace)
    assert torch.equal(seeded.best_x, pinned.best_x)
    ref = jsolver.solve(jp, strat[1], seed=seed, max_iters=MAX_ITERS)
    assert_same_solve(seeded, ref)


def test_seed_may_be_a_key():
    key = prng.split(prng.PRNGKey(11))[1]
    a = tsolver.solve("rastrigin", "fused", seed=key, max_iters=8,
                      device="cpu")
    b = tsolver.solve("rastrigin", "fused", seed=torch.as_tensor(
        key.astype(np.int64)), max_iters=8, device="cpu")
    assert np.array_equal(a.trace, b.trace)
    ref = jsolver.solve("rastrigin", "fused", seed=jnp.asarray(key),
                        max_iters=8)
    assert_same_solve(a, ref)


def test_default_strategy_is_fused():
    res = tsolver.solve("rastrigin", seed=0, max_iters=8, device="cpu")
    assert set(res.extras) == CONTRACTS["fused"]


def test_clustered_from_a_seed():
    """Starts from ``split(PRNGKey(seed), n_clusters)``; the winner, the
    per-cluster values and the summed evaluations against the
    reference's, cluster by cluster under the near-tie rule."""
    jres = jsolver.solve("rastrigin", jsolver.Clustered(n_clusters=4,
                                                        max_bits=10),
                         seed=3, max_iters=32)
    tres = tsolver.solve("rastrigin", tsolver.Clustered(n_clusters=4,
                                                        max_bits=10),
                         seed=3, max_iters=32, device="cpu")
    np.testing.assert_allclose(tres.extras["cluster_values"],
                               jres.extras["cluster_values"], rtol=1e-5,
                               atol=1e-5)
    assert tres.extras["winner"] == jres.extras["winner"]
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    evals = 0
    for k in keys:
        x0 = jax.random.uniform(k, (2,), minval=-5.12, maxval=5.12)
        one = tsolver.solve("rastrigin", tsolver.Fused(max_bits=10),
                            x0=np.asarray(x0), max_iters=32, device="cpu")
        evals += one.extras["evaluations"]
        # the mirror points +-x have one value: the bits may differ
        assert_same_solve(one, jsolver.solve(
            "rastrigin", jsolver.Fused(max_bits=10), x0=x0, max_iters=32),
            same_bits=False)
    assert tres.extras["evaluations"] == evals


def test_clustered_checks_its_starts():
    with pytest.raises(ValueError, match=r"\(n_clusters, n_vars\)"):
        tsolver.solve("rastrigin", tsolver.Clustered(n_clusters=2),
                      x0=np.zeros(2, np.float32), device="cpu")
    with pytest.raises(ValueError, match="3 rows for n_clusters=2"):
        tsolver.solve("rastrigin", tsolver.Clustered(n_clusters=2),
                      x0=np.zeros((3, 2), np.float32), device="cpu")


@pytest.mark.parametrize("n_vars", [2, 20])
def test_fused_nan_child_stalls_the_step(n_vars):
    """The fused step is one run with ``jnp.argmin``'s rule: a NaN child
    wins and stalls the step, however many children there are (the
    distributed engine's blocks would hide it at 20 variables)."""
    jp, tp = _nan_problems(n_vars)
    x0 = np.full(n_vars, -2.0, np.float32)
    ref = jsolver.solve(jp, jsolver.Fused(max_bits=10), x0=jnp.asarray(x0),
                        max_iters=MAX_ITERS)
    port = tsolver.solve(tp, tsolver.Fused(max_bits=10), x0=x0,
                         max_iters=MAX_ITERS, device="cpu")
    assert_same_solve(port, ref)
    assert port.iterations == ref.iterations


def test_all_inf_objective_under_fused():
    enc = (JEnc(3, 8, -4.0, 4.0), TEnc(3, 8, -4.0, 4.0))
    jp = jsolver.Problem(fn=lambda x: jnp.inf + 0.0 * jnp.sum(x),
                         encoding=enc[0])
    tp = tsolver.Problem(fn=lambda x: torch.full(x.shape[:1], torch.inf),
                         encoding=enc[1], batched=True)
    x0 = np.asarray([1.0, -2.0, 3.0], np.float32)
    ref = jsolver.solve(jp, jsolver.Fused(max_bits=12), x0=jnp.asarray(x0))
    port = tsolver.solve(tp, tsolver.Fused(max_bits=12), x0=x0,
                         device="cpu")
    assert port.iterations == ref.iterations == 3
    assert np.array_equal(port.extras["bits"].numpy(),
                          np.asarray(ref.extras["bits"]))
    assert port.extras["finite"] is False


def _host_problems():
    """The reference test's host objective: numpy, one point, a float."""
    def host(x):
        return float(np.sum((np.asarray(x) - 1.25) ** 2))

    enc = (JEnc(3, 8, -4.0, 4.0), TEnc(3, 8, -4.0, 4.0))
    return (jsolver.Problem(fn=host, encoding=enc[0]),
            tsolver.Problem(fn=host, encoding=enc[1]))


@pytest.mark.parametrize("strategy", ["sequential", "fused"])
def test_host_convention_objective(strategy):
    jp, tp = _host_problems()
    assert tp.kind == "numpy" and jp.kind == "numpy"
    x0 = np.asarray([3.0, -3.0, 0.5], np.float32)
    j_strat = {"sequential": jsolver.Sequential(max_bits=10),
               "fused": jsolver.Fused(max_bits=10)}[strategy]
    t_strat = {"sequential": tsolver.Sequential(max_bits=10),
               "fused": tsolver.Fused(max_bits=10)}[strategy]
    ref = jsolver.solve(jp, j_strat, x0=jnp.asarray(x0), max_iters=32)
    port = tsolver.solve(tp, t_strat, x0=x0, max_iters=32, device="cpu")
    assert_same_solve(port, ref)
    # the same objective written for torch gives the same run
    torch_fn = tsolver.Problem(fn=lambda x: ((x - 1.25) ** 2).sum(),
                               encoding=tp.encoding)
    assert torch_fn.kind == "torch"
    again = tsolver.solve(torch_fn, t_strat, x0=x0, max_iters=32,
                          device="cpu")
    assert near_tie_step(_steps(again), _steps(port)) is None


def test_kind_detection_and_host_fn():
    _, tp = _host_problems()
    assert tp.host_fn() is tp.fn
    reg = tsolver.Problem.get("quadratic", n=3)
    assert reg.kind == "torch"
    f = reg.host_fn()
    x = np.asarray([1.0, 2.0, 3.0])
    want = float(reg.fn(torch.as_tensor(x, dtype=torch.float32)[None])[0])
    assert f(x) == want
    with pytest.raises(ValueError, match="kind='numpy'"):
        tsolver.Problem(fn=lambda x: x.no_such_method(),
                        encoding=TEnc(2, 8))
    with pytest.raises(ValueError, match="kind must be"):
        tsolver.Problem(fn=lambda x: x.sum(), encoding=TEnc(2, 8),
                        kind="jax")
    with pytest.raises(ValueError, match="takes one point"):
        tsolver.Problem(fn=lambda x: 0.0, encoding=TEnc(2, 8),
                        kind="numpy", batched=True)


def test_dgo_iteration_and_resolution_step_match_reference():
    enc_j, enc_t = JEnc(3, 8, -5.12, 5.12), TEnc(3, 8, -5.12, 5.12)
    jf = jax.vmap(jsolver.Problem.get("rastrigin", n=3).fn)
    tf = tsolver.Problem.get("rastrigin", n=3).objective.fn
    bits = np.random.default_rng(2).integers(0, 2, 24).astype(np.int8)
    val = np.float32(float(tf(torch.as_tensor(np.zeros((1, 3)),
                                              dtype=torch.float32))[0]) + 90)
    j = jdgo.dgo_iteration(jf, enc_j, jnp.asarray(bits), jnp.float32(val))
    t = tdgo.dgo_iteration(tf, enc_t, torch.as_tensor(bits),
                           torch.tensor(val))
    assert np.array_equal(t.parent_bits.numpy(), np.asarray(j.parent_bits))
    assert bool(t.improved) == bool(j.improved)
    np.testing.assert_allclose(float(t.parent_val), float(j.parent_val),
                               rtol=1e-5, atol=1e-5)
    for max_iters in (3, 64):
        js, jtrace = jdgo.dgo_resolution_step(jf, enc_j, max_iters,
                                              jnp.asarray(bits),
                                              jnp.float32(val))
        ts, ttrace = tdgo.dgo_resolution_step(tf, enc_t, max_iters,
                                              torch.as_tensor(bits),
                                              torch.tensor(val))
        assert int(ts.iters) == int(js.iters)
        assert bool(ts.improved) == bool(js.improved)
        assert np.array_equal(ts.parent_bits.numpy(),
                              np.asarray(js.parent_bits))
        np.testing.assert_allclose(ttrace.numpy(), np.asarray(jtrace),
                                   rtol=1e-5, atol=1e-5)
