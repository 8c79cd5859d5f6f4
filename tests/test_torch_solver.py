"""Whole solves: the PyTorch port's ``solve(..., Distributed(...))`` on the
CPU vs the JAX package's, from the same pinned ``x0``.

Histories must agree step for step within rtol=atol=1e-5 (the reference
kernel's bar) under the near-tie rule: the packages may first part at a
step whose two candidates are within the bar of each other — typically a
last improvement smaller than float32 rounding, which one package sees
and the other does not.  Two children within the bar may also be chosen
differently while the histories still agree, so only the runs named in
``SAME_BITS`` (no near-tie anywhere) must end on the same bit string.
The seeds were picked so that each run is compared over (almost) its
whole length."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solver as jsolver
from repro.core.encoding import Encoding as JEnc
from repro_torch.core import prng
from repro_torch.core import solver as tsolver
from repro_torch.core.encoding import Encoding as TEnc

CONTRACT = {"bits", "bits_resolution", "history", "schedule", "finite"}

# (objective, kwargs, bits override, driver, max_bits, x0 seed)
CASES = {
    "rastrigin3-device": ("rastrigin", {"n": 3}, None, "device", None, 1),
    "rastrigin9-16bit-two-blocks": ("rastrigin", {"n": 9}, 16, "device",
                                    None, 7),
    "shekel-host": ("shekel", {}, None, "host", None, 0),
    "xor-device": ("xor", {}, None, "device", None, 3),
    "rastrigin9-host-8to16": ("rastrigin", {"n": 9}, None, "host", 16, 7),
}
SAME_BITS = {"rastrigin3-device", "shekel-host", "xor-device"}


def _problems(name, kw, bits):
    jp, tp = jsolver.Problem.get(name, **kw), tsolver.Problem.get(name, **kw)
    if bits is not None:
        jp = jp.replace(encoding=jp.encoding.with_bits(bits))
        tp = tp.replace(encoding=tp.encoding.with_bits(bits))
    return jp, tp


def _x0(enc, seed):
    return np.random.default_rng(seed).uniform(
        enc.lo, enc.hi, enc.n_vars).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(case: str, inner: str = "fused"):
    name, kw, bits, driver, max_bits, seed = CASES[case]
    jp, _ = _problems(name, kw, bits)
    x0 = _x0(jp.encoding, seed)
    return jsolver.solve(jp, jsolver.Distributed(
        mesh=1, inner=inner, driver=driver, max_bits=max_bits),
        x0=jnp.asarray(x0)), x0


def near_tie_step(h_p, h_r):
    """None if two histories agree step for step within the bar; else the
    first step where they part, which must be a near-tie (the two values
    of that step within the bar of each other)."""
    h_p, h_r = np.asarray(h_p, np.float64), np.asarray(h_r, np.float64)
    n = min(len(h_p), len(h_r))
    close = np.isclose(h_p[:n], h_r[:n], rtol=1e-5, atol=1e-5)
    if close.all() and len(h_p) == len(h_r):
        return None
    t = n if close.all() else int(np.argmin(close))
    assert t >= 1, "the start values differ"
    a, b = h_p[min(t, len(h_p) - 1)], h_r[min(t, len(h_r) - 1)]
    assert np.isclose(a, b, rtol=1e-5, atol=1e-5), (
        f"histories part at step {t}: {a!r} vs {b!r} is not a near-tie")
    return t


def assert_same_run(port, ref, min_prefix=1.0, same_bits=True):
    """Same run under the near-tie rule; a run that parts at a near-tie
    must have matched for ``min_prefix`` of the reference's steps."""
    assert set(port.extras) == set(ref.extras) == CONTRACT
    h_r = ref.extras["history"]
    t = near_tie_step(port.extras["history"], h_r)
    if t is not None:
        assert t >= min_prefix * (len(h_r) - 1), (t, len(h_r))
        return
    np.testing.assert_allclose(port.trace, ref.trace, rtol=1e-5, atol=1e-5)
    assert port.iterations == ref.iterations
    assert port.extras["bits_resolution"] == ref.extras["bits_resolution"]
    assert port.extras["schedule"] == ref.extras["schedule"]
    if not same_bits:
        return
    assert np.array_equal(port.extras["bits"].numpy(),
                          np.asarray(ref.extras["bits"]))
    assert np.array_equal(port.best_x.numpy().view(np.int32),
                          np.asarray(ref.best_x).view(np.int32))


@pytest.mark.parametrize("inner", ["fused", "popstep", "jnp"])
@pytest.mark.parametrize("case", list(CASES))
def test_solve_matches_reference(case, inner):
    ref, x0 = _reference(case)
    name, kw, bits, driver, max_bits, _ = CASES[case]
    _, tp = _problems(name, kw, bits)
    port = tsolver.solve(tp, tsolver.Distributed(
        inner=inner, driver=driver, max_bits=max_bits), x0=x0, device="cpu")
    assert_same_run(port, ref, min_prefix=0.9, same_bits=case in SAME_BITS)


@pytest.mark.parametrize("inner", ["popstep", "jnp"])
def test_solve_matches_reference_inner_of_the_same_name(inner):
    """The reference's own popstep (Pallas, interpret mode) and literal
    inners give the run the port gives."""
    ref, x0 = _reference("rastrigin3-device", inner)
    _, tp = _problems("rastrigin", {"n": 3}, None)
    port = tsolver.solve(tp, tsolver.Distributed(inner=inner), x0=x0,
                         device="cpu")
    assert_same_run(port, ref)


def _nan_problems(n_vars):
    """(x - 0.5)^2 summed, NaN wherever x_0 > 1.5."""
    enc = (JEnc(n_vars, 8, -4.0, 4.0), TEnc(n_vars, 8, -4.0, 4.0))

    def fj(x):
        return jnp.sum((x - 0.5) ** 2) + jnp.where(x[0] > 1.5, jnp.nan, 0.0)

    def ft(x):
        return ((x - 0.5) ** 2).sum(-1) + torch.where(
            x[:, 0] > 1.5, torch.nan, 0.0)

    return (jsolver.Problem(fn=fj, encoding=enc[0], name="nan"),
            tsolver.Problem(fn=ft, encoding=enc[1], name="nan", batched=True))


@pytest.mark.parametrize("inner", ["fused", "popstep", "jnp"])
@pytest.mark.parametrize("n_vars,blocks", [(2, 1), (20, 2)])
def test_nan_children_follow_the_engine(n_vars, blocks, inner):
    """One block: a NaN child makes the step's value NaN and the run
    stalls.  Two blocks: a NaN child only hides its own block."""
    jp, tp = _nan_problems(n_vars)
    assert -(-jp.encoding.population // 256) == blocks
    x0 = np.full(n_vars, -2.0, np.float32)
    ref = jsolver.solve(jp, jsolver.Distributed(mesh=1, inner="fused"),
                        x0=jnp.asarray(x0))
    port = tsolver.solve(tp, tsolver.Distributed(inner=inner), x0=x0,
                         device="cpu")
    assert_same_run(port, ref)
    if blocks == 1:
        assert port.iterations == 1
    else:
        assert port.iterations > 5 and port.extras["finite"]


def test_near_tie_rule():
    assert near_tie_step([1.0, 0.5, 0.25], [1.0, 0.5, 0.25]) is None
    # a last improvement below the bar, seen by one package only
    assert near_tie_step([1.0, 0.5], [1.0, 0.5, 0.4999999]) == 2
    assert near_tie_step([1.0, 0.5, 0.3], [1.0, 0.5, 0.3000001]) is None
    with pytest.raises(AssertionError, match="not a near-tie"):
        near_tie_step([1.0, 0.5, 0.3], [1.0, 0.5, 0.2])


def test_one_point_objective_is_batched_with_vmap():
    jp = jsolver.Problem(fn=lambda x: jnp.sum(jnp.abs(x - 1.0)),
                         encoding=JEnc(3, 8, -4.0, 4.0))
    tp = tsolver.Problem(fn=lambda x: (x - 1.0).abs().sum(),
                         encoding=TEnc(3, 8, -4.0, 4.0))
    x0 = np.asarray([3.0, -3.0, 0.0], np.float32)
    ref = jsolver.solve(jp, jsolver.Distributed(mesh=1), x0=jnp.asarray(x0))
    port = tsolver.solve(tp, tsolver.Distributed(driver="host"), x0=x0,
                         device="cpu")
    assert_same_run(port, ref)


def test_seeded_start_is_reproducible_and_in_the_box():
    """A seeded solve starts at the threefry twin's draw, the reference's
    ``random_x0(PRNGKey(seed))`` bit for bit, inside the box."""
    a = tsolver.solve("shekel", tsolver.Distributed(), seed=3, device="cpu")
    b = tsolver.solve("shekel", tsolver.Distributed(), seed=3, device="cpu")
    assert a.extras["history"] == b.extras["history"]
    x0 = tsolver.Problem.get("shekel").random_x0(prng.PRNGKey(3))
    ref = np.asarray(jsolver.Problem.get("shekel").random_x0(
        jax.random.PRNGKey(3)))
    assert np.array_equal(x0.view(np.int32), ref.view(np.int32))
    assert x0.shape == (4,) and bool(((x0 >= 0) & (x0 <= 10)).all())
    pinned = tsolver.solve("shekel", tsolver.Distributed(), x0=x0,
                           device="cpu")
    assert pinned.extras["history"] == a.extras["history"]
    assert a.extras["finite"] and set(a.extras) == CONTRACT


def test_device_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsolver.solve("rastrigin", tsolver.Distributed())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsolver.resolve_device(None)


@pytest.mark.parametrize("builder", [
    "make_distributed_step", "make_distributed_engine", "_run_distributed"])
def test_engine_builders_default_to_the_card(monkeypatch, builder):
    """The engine builders take ``device=None`` as the card, like
    ``solve``: without one they raise instead of running on the CPU."""
    from repro_torch.core import distributed as tdist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    obj = tsolver.Problem.get("rastrigin", n=3).objective
    args = (obj, obj.encoding) + ((np.zeros(3, np.float32),)
                                  if builder == "_run_distributed" else ())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(tdist, builder)(*args)
    getattr(tdist, builder)(*args, device="cpu")


def test_unported_strategies_raise():
    """Every strategy key of the reference is registered; an unknown key
    raises with the registered ones."""
    assert tsolver.strategy_names() == jsolver.strategy_names() == (
        "batched", "clustered", "distributed", "fused", "sequential")
    with pytest.raises(ValueError, match=r"unknown strategy 'nonesuch'.*"
                                         r"registered: batched"):
        tsolver.solve("rastrigin", "nonesuch", device="cpu")


def test_popstep_needs_a_device_form_on_cuda():
    """Checked before any tensor reaches the card, so it raises the same
    way with or without one."""
    _, tp = _nan_problems(2)
    for inner in ("popstep", None):
        with pytest.raises(ValueError, match="inner='fused'"):
            tsolver.solve(tp, tsolver.Distributed(inner=inner),
                          x0=np.zeros(2, np.float32), device="cuda")


@pytest.mark.parametrize("strategy,match", [
    (tsolver.Distributed(quorum_mask=[False]), "quorum"),
    (tsolver.Distributed(driver="host", injector="always"), "injection"),
    (tsolver.Distributed(mesh=2), "mesh"),
])
def test_unported_options_raise(strategy, match):
    """The options that raised before meshes were ported now run as the
    reference runs them: a quorum with no live shard takes one step and
    stalls, an injector that fails every round empties the quorum of one
    shard and stops the run at its start, and a mesh of two shards takes
    the one-shard run's steps."""
    from repro_torch.runtime import FailureInjector

    if strategy.injector == "always":
        strategy = dataclasses.replace(strategy,
                                       injector=FailureInjector(1.0))
    x0 = np.asarray([3.1, -2.2], np.float32)
    res = tsolver.solve("rastrigin", strategy, x0=x0, device="cpu")
    assert res.extras["history"][0] == pytest.approx(23.0913, rel=1e-4)
    if match == "mesh":
        one = tsolver.solve("rastrigin", tsolver.Distributed(), x0=x0,
                            device="cpu")
        assert res.extras["history"] == one.extras["history"]
    else:
        assert res.iterations == (1 if match == "quorum" else 0)
        assert float(res.best_f) == res.extras["history"][0]


def test_nonfinite_hygiene():
    _, tp = _nan_problems(2)
    x0 = np.full(2, 3.0, np.float32)          # x_0 > 1.5: NaN from the start
    res = tsolver.solve(tp, tsolver.Distributed(), x0=x0, device="cpu")
    assert res.extras["finite"] is False
    assert not tsolver.result_is_finite(res)
    with pytest.raises(tsolver.NonFiniteResult) as err:
        tsolver.solve(tp, tsolver.Distributed(), x0=x0, device="cpu",
                      on_nonfinite="raise")
    assert err.value.result.extras["finite"] is False
    with pytest.raises(ValueError, match="on_nonfinite"):
        tsolver.solve(tp, x0=x0, device="cpu", on_nonfinite="ignore")
