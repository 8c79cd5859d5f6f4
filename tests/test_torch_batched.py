"""The batched engine of the PyTorch port on the CPU: ``Batched``,
``solve_many``, ``submit_wave`` and ``engine_signature``.

Two contracts.  Inside the port, a request's result through a wave equals
its per-request ``solve(..., Batched(restarts=1))`` bit for bit — whatever
rides the wave beside it, at widths 1, 3 and 8, fixed and folded (the
cases of the reference's ``tests/test_serving.py:56-155``).  Against the
reference, the same requests and restarts follow the reference's runs
under the ROADMAP parity bars: seeded starts bit for bit (the threefry
twin), histories step for step under the near-tie rule of
``tests/test_torch_solver.py``."""
import numpy as np
import pytest
import torch

from repro.core import solver as jsolver
from repro_torch.core import distributed as tdist
from repro_torch.core import prng
from repro_torch.core import solver as tsolver
from repro_torch.core.solver import (
    Batched, Problem, SolveRequest, engine_signature,
)
from repro_torch.kernels.popstep import ops as tops
from repro_torch.serving import RequestQueue
from test_torch_strategies import _close, _plateaus

MAX_ITERS = 24
SPECS = {"rastrigin": {"n": 2}, "quadratic": {"n": 3}, "shekel": {"m": 5}}
EXTRAS = {"bits", "values", "restart_iterations", "trace", "best",
          "schedule", "finite"}


@pytest.fixture(scope="module")
def problems():
    """Three distinct engine signatures, built once (signatures key on
    the objective callable)."""
    return {name: Problem.get(name, **kw) for name, kw in SPECS.items()}


def solve_many(requests, **kwargs):
    return tsolver.solve_many(requests, device="cpu", **kwargs)


def _mixed_requests(problems):
    """Three distinct problems; group sizes chosen so a pad_to=2 wave
    leaves a partially filled last wave for every signature."""
    return [
        SolveRequest(problems["rastrigin"], seed=1, max_iters=MAX_ITERS),
        SolveRequest(problems["quadratic"], x0=[4.0, -3.0, 6.5],
                     max_iters=16),
        SolveRequest(problems["rastrigin"], seed=2, max_iters=MAX_ITERS),
        SolveRequest(problems["shekel"], seed=3, max_iters=MAX_ITERS),
        SolveRequest(problems["rastrigin"], seed=4, max_iters=MAX_ITERS),
    ]


def _per_request(req, max_bits=None):
    """The per-request path: a solve through the batched engine at
    width 1."""
    x0 = None if req.x0 is None else np.asarray(req.x0, np.float32)[None]
    return tsolver.solve(req.problem, Batched(restarts=1, max_bits=max_bits),
                         seed=req.seed, x0=x0, max_iters=req.max_iters,
                         device="cpu")


def _assert_bitwise(out, ref, ctx=None):
    assert float(out.best_f) == float(ref.best_f), ctx
    assert np.array_equal(np.asarray(out.best_x), np.asarray(ref.best_x)), ctx
    assert out.iterations == ref.iterations, ctx
    assert np.array_equal(np.asarray(out.trace), np.asarray(ref.trace)), ctx


# ---------------------------------------------------------------------------
# solve_many: parity with per-request solves of the port
# ---------------------------------------------------------------------------

def test_solve_many_parity_with_per_request_solves(problems):
    """A mixed workload of three problems through waves of two, padded
    last waves included, returns each request's per-request result bit
    for bit."""
    reqs = _mixed_requests(problems)
    outs = solve_many(reqs, pad_to=2)
    assert len(outs) == len(reqs)
    for req, out in zip(reqs, outs):
        _assert_bitwise(out, _per_request(req), req)
        assert out.extras["wave_size"] == 2
        assert (np.diff(out.trace) <= 1e-6).all(), "trace monotone"


def test_solve_many_parity_folded_schedule(problems):
    """The same on the folded schedule, whose host post-processing skips
    padding slots: two requests padded to four."""
    reqs = [SolveRequest(problems["rastrigin"], seed=31, max_iters=16),
            SolveRequest(problems["quadratic"], seed=32, max_iters=16)]
    outs = solve_many(reqs, pad_to=4, max_bits=12)
    for req, out in zip(reqs, outs):
        _assert_bitwise(out, _per_request(req, max_bits=12), req)


def test_solve_many_heterogeneous_caps_share_one_wave(problems):
    """Two requests with different caps ride one wave (the caps are
    per-slot arrays) and each still matches its own solve."""
    reqs = [SolveRequest(problems["rastrigin"], seed=7, max_iters=6),
            SolveRequest(problems["rastrigin"], seed=8, max_iters=MAX_ITERS)]
    outs = solve_many(reqs)
    assert outs[0].iterations <= 6
    for req, out in zip(reqs, outs):
        _assert_bitwise(out, _per_request(req), req)


def test_solve_many_validates_inputs(problems):
    with pytest.raises(ValueError, match="pad_to"):
        solve_many([SolveRequest(problems["rastrigin"])], pad_to=0)
    with pytest.raises(ValueError, match="request x0 must be"):
        solve_many([SolveRequest(problems["rastrigin"], x0=[1.0, 2.0, 3.0])])
    with pytest.raises(ValueError, match="span 2 engine signatures"):
        tsolver.submit_wave([SolveRequest(problems["rastrigin"]),
                             SolveRequest(problems["quadratic"])],
                            device="cpu")
    with pytest.raises(ValueError, match="smaller than"):
        tsolver.submit_wave([SolveRequest(problems["rastrigin"])] * 3,
                            pad_to=2, device="cpu")


def test_engine_signature_buckets(problems):
    """Same problem and configuration, same bucket; another schedule,
    encoding, objective, mesh or virtual block, another bucket.  The
    device is not part of it."""
    a = engine_signature(problems["rastrigin"])
    assert engine_signature(problems["rastrigin"]) == a
    assert engine_signature(problems["quadratic"]) != a
    assert engine_signature(problems["rastrigin"], max_bits=12) != a
    coarse = problems["rastrigin"].replace(
        encoding=problems["rastrigin"].encoding.with_bits(6))
    assert engine_signature(coarse) != a
    assert engine_signature(problems["rastrigin"], mesh=8) != a
    assert engine_signature(problems["rastrigin"], mesh=1) == a
    assert engine_signature(problems["rastrigin"], virtual_block=64) != a
    tagged = problems["rastrigin"].replace(signature=("spec", 1))
    assert engine_signature(tagged)[1] == ("spec", 1)
    assert engine_signature(tagged.replace(fn=lambda x: x.sum(-1))) == \
        engine_signature(tagged)


def test_name_built_requests_share_one_bucket():
    """Requests built from a registry name share a signature
    (``Problem.get`` memoizes per spec)."""
    assert Problem.get("rastrigin", n=2) is Problem.get("rastrigin", n=2)
    a = SolveRequest("rastrigin", seed=0).resolve()
    b = SolveRequest("rastrigin", seed=1).resolve()
    assert engine_signature(a.problem) == engine_signature(b.problem)
    assert Problem.get("rastrigin", n=2) is not Problem.get("rastrigin",
                                                           n=3)
    assert Problem.get("rastrigin") is Problem.get("rastrigin", n=2)
    assert Problem.get("shekel") is Problem.get("shekel", m=5)
    assert Problem.get("shekel", m=7) is not Problem.get("shekel")


def test_bad_x0_rejected_at_submission_not_in_wave(problems):
    q = RequestQueue()
    with pytest.raises(ValueError, match=r"request x0 must be \(2,\)"):
        q.submit(SolveRequest(problems["rastrigin"], x0=[1.0, 2.0, 3.0]))
    assert len(q) == 0


# ---------------------------------------------------------------------------
# slot independence: a slot's result does not depend on the wave
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_bits", [None, 12], ids=["fixed", "folded"])
@pytest.mark.parametrize("width", [1, 3, 8])
def test_slot_independent_of_wave_width(problems, width, max_bits):
    """Requests with mixed seeds and caps in waves of 1, 3 and 8 (the
    last one padded): every slot equals its per-request solve bit for
    bit, and so equals itself in a wave of another width."""
    prob = problems["rastrigin"]
    if max_bits is not None:
        prob = prob.replace(encoding=prob.encoding.with_bits(8))
    reqs = [SolveRequest(prob, seed=70 + i, max_iters=(5, 40, 12)[i % 3])
            for i in range(width + 1)]
    outs = solve_many(reqs, pad_to=width, max_bits=max_bits)
    for i, (req, out) in enumerate(zip(reqs, outs)):
        _assert_bitwise(out, _per_request(req, max_bits), req)
        assert out.extras["wave_slot"] == i % width
        assert out.extras["wave_size"] == width


def test_batched_popstep_plain_step_equals_fused_step(problems):
    """The R-restart popstep step (its plain version on the CPU: the
    one-parent step on each live parent) and the plain tensor step give
    the batched engine the same run, bit for bit."""
    obj = problems["rastrigin"].objective
    x0s = np.asarray([[3.1, -2.2], [0.5, 4.4], [-1.9, -3.3]], np.float32)
    runs = [tdist._run_batched(obj, obj.encoding, x0s, max_iters=32,
                               slot_iters=[32, 5, 32], inner=inner,
                               device="cpu")
            for inner in ("fused", "popstep")]
    assert np.array_equal(runs[0].trace, runs[1].trace)
    assert np.array_equal(runs[0].iterations, runs[1].iterations)
    assert torch.equal(runs[0].bits, runs[1].bits)
    assert runs[0].iterations[1] == 5


def test_submit_wave_is_solve_many(problems):
    reqs = [SolveRequest(problems["shekel"], seed=s, max_iters=MAX_ITERS)
            for s in (5, 6, 7)]
    pending = tsolver.submit_wave(reqs, pad_to=4, device="cpu")
    outs = pending.finalize(timeout=60)
    for out, ref in zip(outs, solve_many(reqs, pad_to=4)):
        _assert_bitwise(out, ref)
        assert out.extras["wave_size"] == 4 and out.extras["finite"]


def test_concurrent_waves_equal_serial_waves(problems):
    """Waves in flight at once share one engine and its bound steps (each
    wave's loop on its own thread): more waves than cores, with a short
    thread switch interval, give each wave the result it gives alone."""
    import os
    import sys

    reqs = [[SolveRequest(problems["rastrigin"], seed=10 * w + i,
                          max_iters=12 + w) for i in range(3)]
            for w in range(2 * (os.cpu_count() or 4))]
    serial = [solve_many(wave, pad_to=4) for wave in reqs]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pending = [tsolver.submit_wave(wave, pad_to=4, device="cpu")
                   for wave in reqs]
        outs = [p.finalize(timeout=120) for p in pending]
    finally:
        sys.setswitchinterval(interval)
    for got, want in zip(outs, serial):
        for out, ref in zip(got, want):
            _assert_bitwise(out, ref)


def test_wave_error_surfaces_at_finalize(problems):
    """An error inside a wave's loop (here: an objective that raises)
    reaches the caller at ``finalize``, not at submit."""
    def broken(x):
        raise FloatingPointError("objective exploded")

    prob = Problem(fn=broken, encoding=problems["rastrigin"].encoding,
                   batched=True, kind="torch", name="broken")
    with pytest.raises(FloatingPointError, match="exploded"):
        tsolver.submit_wave([SolveRequest(prob, seed=1)], device="cpu")
    calls = []

    def flaky(x):
        calls.append(x.shape[0])
        if len(calls) > 1:
            raise FloatingPointError("objective exploded in the loop")
        return (x ** 2).sum(-1)

    prob = Problem(fn=flaky, encoding=problems["rastrigin"].encoding,
                   batched=True, kind="torch", name="flaky")
    pending = tsolver.submit_wave([SolveRequest(prob, seed=1)],
                                  device="cpu")
    with pytest.raises(FloatingPointError, match="in the loop"):
        pending.finalize(timeout=60)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def _jrequests(reqs):
    """The same requests for the reference, problem by problem."""
    by_name = {Problem.get(k, **kw).name: jsolver.Problem.get(k, **kw)
               for k, kw in SPECS.items()}
    return [jsolver.SolveRequest(by_name[r.problem.name], seed=r.seed,
                                 x0=r.x0, max_iters=r.max_iters)
            for r in reqs]


def _follows(h_p, h_r, ctx=None):
    """The near-tie rule of ``tests/test_torch_strategies.py`` for one
    history: None when step for step within the bar; else the runs may
    part only at a near-tie (one package takes a step within the bar of
    the last, below float32 rounding, that the other does not, and they go
    on a step apart), so they move through the same values."""
    h_p, h_r = np.asarray(h_p, np.float64), np.asarray(h_r, np.float64)
    assert _close(h_p[0], h_r[0]), ("the start values differ", ctx)
    if len(h_p) == len(h_r) and _close(h_p, h_r).all():
        return None
    p_p, p_r = _plateaus(h_p), _plateaus(h_r)
    assert len(p_p) == len(p_r) and _close(p_p, p_r).all(), (
        f"the runs part beyond a near-tie: {p_p} vs {p_r}", ctx)
    assert any(np.any((np.diff(h) < 0) & _close(h[1:], h[:-1]))
               for h in (h_p, h_r)), ("a part without a near-tie", ctx)
    return "near-tie"


def _assert_follows(out_p, out_r, ctx):
    if _follows(out_p.trace, out_r.trace, ctx) is None:
        assert out_p.iterations == out_r.iterations, ctx
    assert _close(float(out_p.best_f), float(out_r.best_f)), ctx


@pytest.mark.parametrize("max_bits", [None, 12], ids=["fixed", "folded"])
def test_solve_many_follows_the_reference(problems, max_bits):
    reqs = _mixed_requests(problems)
    if max_bits is not None:
        reqs = [r for r in reqs if r.x0 is None]
    outs_p = solve_many(reqs, pad_to=2, max_bits=max_bits)
    outs_r = jsolver.solve_many(_jrequests(reqs), pad_to=2,
                                max_bits=max_bits)
    for req, p, r in zip(reqs, outs_p, outs_r):
        assert set(p.extras) == set(r.extras), req
        assert p.extras["wave_slot"] == r.extras["wave_slot"]
        assert p.extras["schedule"] == r.extras["schedule"]
        _assert_follows(p, r, req)


@pytest.mark.parametrize("max_bits", [None, 12], ids=["fixed", "folded"])
@pytest.mark.parametrize("name", ["rastrigin", "shekel"])
def test_batched_follows_the_reference(name, max_bits):
    kw = {"rastrigin": {"n": 2}, "shekel": {"m": 5}}[name]
    tp, jp = Problem.get(name, **kw), jsolver.Problem.get(name, **kw)
    port = tsolver.solve(tp, Batched(restarts=4, max_bits=max_bits),
                         seed=11, max_iters=MAX_ITERS, device="cpu")
    ref = jsolver.solve(jp, jsolver.Batched(restarts=4, max_bits=max_bits),
                        seed=11, max_iters=MAX_ITERS)
    assert set(port.extras) == set(ref.extras) == EXTRAS
    assert port.extras["schedule"] == ref.extras["schedule"]
    its_p = np.asarray(port.extras["restart_iterations"])
    its_r = np.asarray(ref.extras["restart_iterations"])
    tied = False
    for r in range(4):
        tied |= _follows(port.extras["trace"][r][: its_p[r] + 1],
                         ref.extras["trace"][r][: its_r[r] + 1], r) \
            is not None
    if not tied:
        assert port.extras["best"] == ref.extras["best"]
        assert np.allclose(port.extras["values"].numpy(),
                           np.asarray(ref.extras["values"]), rtol=1e-5,
                           atol=1e-5)


@pytest.mark.parametrize("name,kw", [("rastrigin", {"n": 2}),
                                     ("shekel", {"m": 5}),
                                     ("remote_sensing", {})])
def test_seeded_request_starts_at_the_reference_draw(name, kw):
    """A seeded request's start is the reference's, bit for bit (the
    threefry twin), as a per-request ``Batched(restarts=1)`` draws it."""
    tp, jp = Problem.get(name, **kw), jsolver.Problem.get(name, **kw)
    for seed in (0, 3, 77):
        x_p = tsolver._request_x0(tp, SolveRequest(tp, seed=seed))
        x_r = np.asarray(jsolver._request_x0(jp, jsolver.SolveRequest(
            jp, seed=seed)))
        assert np.array_equal(x_p.view(np.int32), x_r.view(np.int32))
        assert np.array_equal(x_p, tp.random_x0(prng.PRNGKey(seed),
                                                batch=1)[0])


def test_engine_signature_groups_like_the_reference(problems):
    """Both packages cut the same requests into the same buckets."""
    reqs = _mixed_requests(problems) * 2
    for kwargs in ({}, {"max_bits": 12}, {"virtual_block": 64}):
        sig_p = [engine_signature(r.problem, **kwargs) for r in reqs]
        sig_r = [jsolver.engine_signature(r.problem, **kwargs)
                 for r in _jrequests(reqs)]
        groups_p = [sig_p.index(s) for s in sig_p]
        groups_r = [sig_r.index(s) for s in sig_r]
        assert groups_p == groups_r
        assert [len(s) for s in sig_p] == [len(s) for s in sig_r]


# ---------------------------------------------------------------------------
# the R-restart kernel wrapper's input checks (card-free)
# ---------------------------------------------------------------------------

class _Stream:
    def __init__(self, handle):
        self.cuda_stream = handle


def _bound_step(restarts):
    """A ``_CudaStep`` on a stand-in device: its checks run before any
    launch."""
    enc = Problem.get("rastrigin", n=2).encoding
    return tops._CudaStep(None, enc, torch.device("cpu"), enc.population,
                          (), [], restarts, 1, 0), enc


def test_cuda_step_checks_the_restart_axis(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream(7))
    step, enc = _bound_step(3)
    parents = torch.zeros((3, enc.n_bits), dtype=torch.int8)
    with pytest.raises(ValueError,
                       match=rf"parent_bits must be \(3, {enc.n_bits}\)"):
        step._check(parents[0], None)
    with pytest.raises(ValueError, match="torch.bool"):
        step._check(parents, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"live must be \(3,\)"):
        step._check(parents, torch.ones(2, dtype=torch.bool))
    assert step._check(parents, torch.ones(3, dtype=torch.bool)) == 7
    one, _ = _bound_step(None)
    with pytest.raises(ValueError, match="restarts=R"):
        one._check(parents[0], torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError,
                       match=rf"parent_bits must be \({enc.n_bits},\)"):
        one._check(parents, None)


def test_cuda_step_refuses_a_second_stream(monkeypatch):
    """A bound step keeps its selection state on the card between
    launches, so it runs on the stream of its first launch only."""
    stream = [_Stream(7)]
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: stream[0])
    step, enc = _bound_step(2)
    parents = torch.zeros((2, enc.n_bits), dtype=torch.int8)
    assert step._check(parents, None) == 7
    assert step._check(parents, None) == 7
    stream[0] = _Stream(9)
    with pytest.raises(RuntimeError, match="bind another step for stream"):
        step._check(parents, None)
