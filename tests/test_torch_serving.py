"""The port's serving stack on the CPU: ``repro_torch.serving``'s queue,
scheduler, pipeline, chaos harness and metrics, and ``repro_torch.runtime``
(fault plans, the straggler policy, elastic planning), through the cases
of the reference's ``tests/test_serving.py``, ``test_pipeline.py``,
``test_chaos.py`` and ``test_runtime.py``, run on the port with
``device="cpu"``.  Completions are held bit for bit against the port's own
fault-free path (its per-request solves or ``solve_many``); the port's
results against the reference's are ``tests/test_torch_batched.py``'s.

Every wait has a bound: the schedulers here drain within ``DRAIN_S`` and
close within ``CLOSE_S`` or raise ``TimeoutError``, and a handle's result
is read only once it is done.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import solver as tsolver
from repro_torch.core.solver import (
    Batched, NonFiniteResult, Problem, SolveRequest, engine_signature,
)
from repro_torch.runtime.failure import (
    FailureInjector, FaultPlan, PoisonError, SimulatedFailure,
)
from repro_torch.runtime.straggler import StragglerPolicy
from repro_torch.serving import (
    DeadlineExceeded, DispatchFailed, QueueFull, RequestQueue, percentile,
)
from repro_torch.serving import pipeline as serving_pipeline
from repro_torch.serving import scheduler as serving_scheduler
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.runtime import elastic_population_plan

pytestmark = pytest.mark.timeout(300)

SERVE_ITERS = 24     # test_serving.py's MAX_ITERS
MAX_ITERS = 8        # test_pipeline.py's and test_chaos.py's
DRAIN_S = 120.0
CLOSE_S = 60.0


class Scheduler(serving_scheduler.Scheduler):
    """The synchronous scheduler on the CPU, every drain bounded."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("device", "cpu")
        super().__init__(*args, **kwargs)

    def drain(self, timeout_s=DRAIN_S):
        return super().drain(timeout_s)


class PipelinedScheduler(serving_pipeline.PipelinedScheduler):
    """The pipelined scheduler on the CPU, every drain and close
    bounded."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("device", "cpu")
        super().__init__(*args, **kwargs)

    def drain(self, timeout_s=DRAIN_S):
        return super().drain(timeout_s)

    def close(self, timeout_s=CLOSE_S):
        return super().close(timeout_s)


def solve_many(requests, **kwargs):
    kwargs.setdefault("device", "cpu")
    return tsolver.solve_many(requests, **kwargs)


def solve(problem, strategy="fused", **kwargs):
    kwargs.setdefault("device", "cpu")
    return tsolver.solve(problem, strategy, **kwargs)


BOTH = pytest.mark.parametrize(
    "make_sched", [Scheduler, PipelinedScheduler],
    ids=["synchronous", "pipelined"])


@pytest.fixture(scope="module")
def problems():
    """Three distinct engine signatures, built once (signatures key on
    the objective callable)."""
    return {
        "rastrigin": Problem.get("rastrigin", n=2),
        "quadratic": Problem.get("quadratic", n=3),
        "shekel": Problem.get("shekel", m=5),
    }


def _mixed_requests(problems):
    """Three distinct problems; group sizes chosen so a pad_to=2 dispatch
    leaves a partially-filled final bucket for every signature."""
    return [
        SolveRequest(problems["rastrigin"], seed=1, max_iters=SERVE_ITERS),
        SolveRequest(problems["quadratic"], x0=[4.0, -3.0, 6.5],
                     max_iters=16),
        SolveRequest(problems["rastrigin"], seed=2, max_iters=SERVE_ITERS),
        SolveRequest(problems["shekel"], seed=3, max_iters=SERVE_ITERS),
        SolveRequest(problems["rastrigin"], seed=4, max_iters=SERVE_ITERS),
    ]


def _per_request(req, max_bits=None):
    """The per-request path: a solve through the batched engine at
    width 1."""
    x0 = None if req.x0 is None else np.asarray(req.x0, np.float32)[None]
    return solve(req.problem, Batched(restarts=1, max_bits=max_bits),
                 seed=req.seed, x0=x0, max_iters=req.max_iters)


def _fault_free(req):
    """The fault-free result of ``req`` (the chaos parity baseline)."""
    (res,) = solve_many([req])
    return res


def _assert_bitwise(res, ref, ctx=None):
    assert float(res.best_f) == float(ref.best_f), ctx
    assert np.array_equal(np.asarray(res.best_x),
                          np.asarray(ref.best_x)), ctx
    assert res.iterations == ref.iterations, ctx
    assert np.array_equal(np.asarray(res.trace),
                          np.asarray(ref.trace)), ctx


def _assert_handle_bitwise(handle, ref):
    assert handle.done(), handle
    _assert_bitwise(handle.result(), ref, handle)


def _nan_problem(problems):
    base = problems["quadratic"]
    return base.replace(fn=lambda x: x.sum(-1) * torch.nan, name="nanprob")


@pytest.mark.timeout(120)
def test_solve_flags_nonfinite_results(problems):
    from repro_torch.core.solver import Fused, result_is_finite
    prob = _nan_problem(problems)
    x0 = np.asarray([1.0, 2.0, 3.0], np.float32)
    res = solve(prob, Fused(max_bits=8), x0=x0, max_iters=4)
    assert res.extras["finite"] is False
    assert not result_is_finite(res)
    with pytest.raises(NonFiniteResult) as ei:
        solve(prob, Fused(max_bits=8), x0=x0, max_iters=4,
              on_nonfinite="raise")
    assert not result_is_finite(ei.value.result)
    # the finite case flags True on the same path
    ok = solve(problems["quadratic"], Fused(max_bits=8), x0=x0, max_iters=4)
    assert ok.extras["finite"] is True


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_queue_priority_and_fifo(problems):
    q = RequestQueue()
    low = q.submit(SolveRequest(problems["rastrigin"], seed=0, priority=0))
    hi = q.submit(SolveRequest(problems["rastrigin"], seed=1, priority=5))
    mid = q.submit(SolveRequest(problems["rastrigin"], seed=2, priority=1))
    low2 = q.submit(SolveRequest(problems["rastrigin"], seed=3, priority=0))
    assert len(q) == 4
    popped = q.pop_bucket(4)
    assert popped == [hi, mid, low, low2]   # priority desc, FIFO within
    assert len(q) == 0

def test_queue_pop_bucket_groups_by_signature(problems):
    q = RequestQueue()
    sched = Scheduler(q, wave_size=4)
    r1 = q.submit(SolveRequest(problems["rastrigin"], seed=0))
    q1 = q.submit(SolveRequest(problems["quadratic"], seed=1))
    r2 = q.submit(SolveRequest(problems["rastrigin"], seed=2))
    bucket = q.pop_bucket(4, key=sched.signature)
    assert bucket == [r1, r2]               # q1 skipped, still queued
    assert len(q) == 1
    assert q.pop_bucket(4, key=sched.signature) == [q1]

def test_queue_submit_coerces_and_validates():
    q = RequestQueue()
    h = q.submit("rastrigin", seed=0, max_iters=4)
    assert isinstance(h.request, SolveRequest)
    assert h.request.problem.name == "rastrigin2d"
    with pytest.raises(ValueError, match="unknown objective"):
        q.submit("warp-drive")
    with pytest.raises(TypeError, match="kwargs"):
        q.submit(SolveRequest("rastrigin"), seed=3)

def test_scheduler_drains_mixed_workload(problems):
    sched = Scheduler(wave_size=2)
    reqs = _mixed_requests(problems)
    handles = [sched.submit(r) for r in reqs]
    assert sched.drain() == len(reqs)
    for h, req in zip(handles, reqs):
        assert h.done() and h.error is None
        ref = _per_request(req)
        assert float(h.result().best_f) == float(ref.best_f)
    m = sched.metrics()
    assert m["completed"] == len(reqs)
    assert m["failed"] == 0
    assert m["waves"] == 4          # rastrigin 2 waves, quadratic/shekel 1
    assert m["padded_slots"] == 3   # three partially-filled final buckets
    assert m["fill_fraction"] == pytest.approx(5 / 8)
    assert m["latency_p95_ms"] >= m["latency_p50_ms"] > 0
    assert m["cache"]["totals"]["built"] >= 1
    assert m["pending"] == 0

def test_scheduler_warmup_builds_once(problems):
    from repro_torch.core import cache
    cache.clear()
    sched = Scheduler(wave_size=2)
    n = sched.warmup([problems["rastrigin"], problems["rastrigin"],
                      problems["quadratic"]], max_iters=SERVE_ITERS)
    assert n == 2                           # distinct signatures only
    built = cache.get_cache("distributed.engine").stats()["built"]
    for seed in (11, 12, 13):
        sched.submit(SolveRequest(problems["rastrigin"], seed=seed,
                                  max_iters=SERVE_ITERS))
    sched.drain()
    # steady-state serving: the warmed engine is reused, nothing rebuilt
    assert cache.get_cache("distributed.engine").stats()["built"] == built
    assert sched.metrics()["warmup_waves"] == 2

def test_scheduler_requeues_and_recovers_after_injected_failure(problems):
    """An injected dispatch failure requeues the bucket with retry
    accounting; once the fault clears the retried requests complete."""
    inj = FailureInjector(rate=1.0, seed=0)
    sched = Scheduler(wave_size=2, injector=inj, max_retries=2)
    h = sched.submit(SolveRequest(problems["rastrigin"], seed=21,
                                  max_iters=SERVE_ITERS))
    assert sched.run_wave() == 0            # injected failure -> requeued
    assert h.retries == 1 and not h.done()
    assert len(sched.queue) == 1
    inj.rate = 0.0                          # fault clears
    assert sched.drain() == 1
    assert h.done() and h.error is None
    m = sched.metrics()
    assert m["requeued"] == 1 and m["failed_waves"] == 1
    assert m["injected_failures"] == 1

def test_scheduler_fails_request_after_retry_budget(problems):
    sched = Scheduler(wave_size=2, injector=FailureInjector(rate=1.0),
                      max_retries=1, retry_backoff_s=0.0)
    h = sched.submit(SolveRequest(problems["rastrigin"], seed=22,
                                  max_iters=SERVE_ITERS))
    sched.drain()
    assert h.done() and h.retries == 2      # initial try + 1 retry
    # each exhausted handle gets its OWN DispatchFailed chained from the
    # shared dispatch error — never the same exception object across a
    # whole bucket
    assert isinstance(h.error, DispatchFailed)
    assert h.error.seq == h.seq
    assert isinstance(h.error.__cause__, SimulatedFailure)
    with pytest.raises(DispatchFailed):
        h.result()
    assert sched.metrics()["failed"] == 1

def test_straggler_policy_feeds_wave_size():
    """Recent dispatch times are the policy's virtual lanes: a straggling
    dispatch masks lanes and shrinks the next waves (snapped to halvings
    of wave_size, so shrinks cost at most log2(W) engine widths) until
    the cooldown expires."""
    policy = StragglerPolicy(n_shards=4, factor=2.0, cooldown=2)
    sched = Scheduler(wave_size=8, straggler=policy)
    assert sched.effective_wave_size() == 8
    for t in (0.01, 0.01, 0.01, 0.5):       # one lane 50x the median
        sched._note_dispatch_time(t)
    assert sched.effective_wave_size() == 4  # 3/4 lanes -> snapped to W/2
    for t in [0.01] * 6:    # straggler leaves the window + cooldown decays
        sched._note_dispatch_time(t)
    assert sched.effective_wave_size() == 8

def test_effective_wave_size_halving_sequence():
    """Widths snap DOWN the halving ladder of wave_size as the quorum
    fraction decays — at W=8 exactly 8 -> 4 -> 2 -> 1, never 7 or 3
    (each distinct width is its own engine per signature, so free-form
    shrinks would answer one straggler with engine builds)."""

    class _Quorum:                      # the policy surface the scheduler
        n_shards = 8                    # reads: n_shards + quorum_fraction
        quorum_fraction = 1.0

    sched = Scheduler(wave_size=8, straggler=_Quorum())
    expected = {1.0: 8, 0.9: 4, 0.6: 4, 0.5: 4, 0.3: 2, 0.2: 2, 0.05: 1}
    for frac, width in expected.items():
        sched.straggler.quorum_fraction = frac
        assert sched.effective_wave_size() == width, frac

def test_percentile():
    assert percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert percentile([1.0, 2.0], 100) == 2.0
    assert percentile([1.0, 2.0], 0) == 1.0
    assert percentile([1.0, 2.0], 50) == 1.5
    with pytest.raises(ValueError):
        percentile([], 50)
    with pytest.raises(ValueError):
        percentile([1.0], 101)

def test_metrics_snapshot_shape():
    m = ServingMetrics()
    m.record_wave(n_active=3, width=4, elapsed_s=0.5)
    m.record_completion(0.1)
    m.record_completion(0.3)
    snap = m.snapshot()
    assert snap["completed"] == 2
    assert snap["slots"] == 4 and snap["padded_slots"] == 1
    assert snap["fill_fraction"] == pytest.approx(0.75)
    assert snap["latency_p50_ms"] == pytest.approx(200.0)
    # the cache snapshot rides along for the serving endpoint
    assert set(snap["cache"]) == {"caches", "totals"}
    assert "evictions" in snap["cache"]["totals"]
    # engine-cache churn is surfaced top-level
    assert snap["cache_evictions"] == snap["cache"]["totals"]["evictions"]

# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


@pytest.mark.timeout(240)
def test_pipelined_matches_synchronous_bitwise(problems):
    """ACCEPTANCE: the same mixed-signature workload through the
    synchronous and the pipelined scheduler completes bitwise identical
    (and identical to per-request ``solve_many``)."""
    reqs = [SolveRequest(problems["rastrigin" if i % 3 else "quadratic"],
                         seed=300 + i, max_iters=MAX_ITERS)
            for i in range(10)]
    sync = Scheduler(wave_size=4)
    sync_handles = [sync.submit(r) for r in reqs]
    assert sync.drain() == len(reqs)
    with PipelinedScheduler(wave_size=4, max_in_flight=2) as piped:
        piped_handles = [piped.submit(r) for r in reqs]
        assert piped.drain() == len(reqs)
        m = piped.metrics()
    for req, hs, hp in zip(reqs, sync_handles, piped_handles):
        assert hp.error is None, hp
        (ref,) = solve_many([req])
        _assert_bitwise(hp.result(), hs.result(), hp)
        _assert_bitwise(hp.result(), ref, hp)
    # the pipelined snapshot carries the depth rows (the synchronous
    # scheduler pins them at depth 1 / overlap 0.0)
    assert m["max_in_flight_depth"] >= 1
    assert 0.0 <= m["overlap_fraction"] <= 1.0
    sync_m = sync.metrics()
    assert sync_m["max_in_flight_depth"] == 1
    assert sync_m["overlap_fraction"] == 0.0

class _GatedPending:
    """A PendingWave stand-in whose finalize blocks on an Event, so the
    test controls exactly when the worker can retire a wave."""

    def __init__(self, reqs, pad_to, gate):
        self.reqs = reqs
        self.pad_to = pad_to
        self.gate = gate

    def wait(self):
        assert self.gate.wait(timeout=60), "test gate never opened"

    def finalize(self):
        self.wait()
        return solve_many(self.reqs, pad_to=self.pad_to)

@pytest.mark.timeout(240)
def test_pump_backpressure_caps_in_flight_depth(problems, monkeypatch):
    
    gate = threading.Event()
    monkeypatch.setattr(
        serving_pipeline, "submit_wave",
        lambda reqs, pad_to=None, **kw: _GatedPending(reqs, pad_to, gate))
    sched = PipelinedScheduler(wave_size=1, max_in_flight=2)
    try:
        reqs = [SolveRequest(problems["rastrigin"], seed=400 + i,
                             max_iters=MAX_ITERS) for i in range(4)]
        handles = [sched.submit(r) for r in reqs]
        assert sched.pump() and sched.pump()       # two waves submitted
        assert sched.in_flight == 2
        assert not sched.pump(), "pump must refuse past max_in_flight"
        assert sched.in_flight == 2 and len(sched.queue) == 2
        assert not any(h.done() for h in handles), \
            "nothing finalizes while the gate is shut"
        gate.set()
        assert sched.drain() == 4
    finally:
        gate.set()
        sched.close()
    for req, h in zip(reqs, handles):
        (ref,) = solve_many([req])
        _assert_bitwise(h.result(), ref, h)
    m = sched.metrics()
    assert m["max_in_flight_depth"] == 2
    assert m["overlap_fraction"] > 0.0

def test_max_in_flight_validated():
    with pytest.raises(ValueError, match="max_in_flight"):
        PipelinedScheduler(max_in_flight=0)

@pytest.mark.timeout(120)
@BOTH
def test_backoff_release_races_deadline_expiry(problems, make_sched):
    """A bucket fails and backs off; one member's deadline lapses DURING
    the backoff sleep.  At release, the same drain tick sees both edges —
    the expiry must win: the retried wave carries only the live request,
    the expired one fails at pop without ever occupying a slot."""
    plan = FaultPlan(seed=0, error_dispatches={1})
    sched = make_sched(wave_size=2, faults=plan, max_retries=2,
                       retry_backoff_s=0.08, backoff_cap_s=0.08,
                       backoff_jitter=0.0)
    try:
        doomed = sched.submit(SolveRequest(
            problems["rastrigin"], seed=1, max_iters=MAX_ITERS,
            deadline_s=0.02))
        live_req = SolveRequest(problems["rastrigin"], seed=2,
                                max_iters=MAX_ITERS)
        live = sched.submit(live_req)
        sched.drain()
    finally:
        sched.close()
    assert plan.injected_errors == 1
    assert isinstance(doomed.error, DeadlineExceeded)
    assert live.error is None
    (ref,) = solve_many([live_req])
    _assert_bitwise(live.result(), ref, live)
    m = sched.metrics()
    assert m["expired"] == 1 and m["failed_waves"] == 1
    assert m["backoff_s"] > 0, "drain slept out the backoff, no hot spin"
    # the proof: one successful wave with exactly ONE active slot — the
    # expired request was failed at pop, not retried alongside the
    # survivor when the backoff released
    assert m["waves"] == 1
    assert m["slots"] - m["padded_slots"] == 1

class _AuditedQueue(RequestQueue):
    """Tracks the peak of (queued + in-flight) requests across every
    requeue — the accounting a bounded queue must never blow through."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.sched = None
        self.peak = 0

    def requeue(self, handle):
        super().requeue(handle)
        inflight = 0
        if self.sched is not None:
            with self.sched._flight:
                inflight = sum(len(f.bucket)
                               for f in self.sched._inflight)
        with self._lock:
            self.peak = max(self.peak, len(self._heap) + inflight)

@pytest.mark.timeout(240)
def test_inflight_wave_plus_bisection_respects_capacity(problems):
    """REGRESSION: a full wave in flight on the worker while quarantine
    bisection requeues probe remainders must never push queued +
    in-flight past the queue's capacity — requeues reuse slots the
    bucket already held, they never grow the backlog."""
    capacity = 8
    q = _AuditedQueue(capacity=capacity)
    plan = FaultPlan(seed=0)
    sched = PipelinedScheduler(q, wave_size=4, max_in_flight=2,
                               faults=plan, max_retries=1,
                               retry_backoff_s=0.0)
    q.sched = sched
    try:
        poisoned_reqs = [SolveRequest(problems["rastrigin"], seed=70 + i,
                                      max_iters=MAX_ITERS)
                         for i in range(4)]
        clean_reqs = [SolveRequest(problems["quadratic"], seed=80 + i,
                                   max_iters=MAX_ITERS) for i in range(4)]
        poisoned = [sched.submit(r) for r in poisoned_reqs]
        clean = [sched.submit(r) for r in clean_reqs]
        plan.poison_seqs = frozenset({poisoned[2].seq})
        sched.drain()
    finally:
        sched.close()
    assert q.peak <= capacity, \
        f"backlog accounting peaked at {q.peak} > capacity {capacity}"
    assert isinstance(poisoned[2].error, DispatchFailed)
    assert isinstance(poisoned[2].error.__cause__, PoisonError)
    for i, (h, req) in enumerate(zip(poisoned + clean,
                                     poisoned_reqs + clean_reqs)):
        if i == 2:
            continue
        assert h.error is None, h
        (ref,) = solve_many([req])
        _assert_bitwise(h.result(), ref, h)
    m = sched.metrics()
    assert m["bisected_waves"] >= 1
    assert m["completed"] == 7 and m["failed"] == 1

@pytest.mark.timeout(240)
def test_faultplan_deterministic_under_pipelining(problems):
    """Dispatch indices are assigned at SUBMIT time in pop order on the
    scheduler thread, so a seeded FaultPlan replays identically through
    the two-thread pipeline: two identical runs, identical outcomes."""
    def run():
        plan = FaultPlan(seed=5, dispatch_error_rate=0.3,
                         error_dispatches={2}, latency_dispatches={3},
                         latency_s=0.001, max_failures=6)
        with PipelinedScheduler(wave_size=2, max_in_flight=2, faults=plan,
                                max_retries=3,
                                retry_backoff_s=0.0) as sched:
            handles = [sched.submit(SolveRequest(
                problems["rastrigin"], seed=500 + i, max_iters=MAX_ITERS))
                for i in range(6)]
            sched.drain()
        outcomes = []
        for h in handles:
            outcomes.append((
                type(h.error).__name__ if h.error is not None else None,
                h.retries,
                float(h.result().best_f) if h.error is None else None))
        return plan.injected, outcomes

    injected_a, outcomes_a = run()
    injected_b, outcomes_b = run()
    assert injected_a == injected_b >= 1
    assert outcomes_a == outcomes_b

@pytest.mark.timeout(120)
def test_worker_crash_fails_inflight_and_raises_in_drain(problems):
    """A bug past _finalize's own dispatch-failure handler (here: a
    completion-path explosion) must fail the in-flight handles and
    surface in drain() — never a silent hang on result()."""
    sched = PipelinedScheduler(wave_size=2, max_in_flight=2)
    sched._complete_bucket = lambda bucket, results: (
        (_ for _ in ()).throw(RuntimeError("completion-path bug")))
    try:
        h = sched.submit(SolveRequest(problems["rastrigin"], seed=9,
                                      max_iters=MAX_ITERS))
        with pytest.raises(RuntimeError, match="dispatch worker crashed"):
            sched.drain()
    finally:
        sched.close()
    assert h.done() and isinstance(h.error, RuntimeError)
    assert "dispatch worker crashed" in str(h.error)
    assert isinstance(h.error.__cause__, RuntimeError)
    with pytest.raises(RuntimeError):
        h.result()

@pytest.mark.timeout(120)
def test_close_is_idempotent_and_restartable(problems):
    sched = PipelinedScheduler(wave_size=2)
    req = SolveRequest(problems["quadratic"], seed=21, max_iters=MAX_ITERS)
    h1 = sched.submit(req)
    assert sched.drain() == 1
    sched.close()
    sched.close()                           # idempotent
    # the next drain revives the worker lazily
    h2 = sched.submit(req)
    assert sched.drain() == 1
    sched.close()
    _assert_bitwise(h2.result(), h1.result())

@pytest.mark.timeout(120)
def test_context_manager_joins_worker(problems):
    with PipelinedScheduler(wave_size=2) as sched:
        h = sched.submit(SolveRequest(problems["quadratic"], seed=22,
                                      max_iters=MAX_ITERS))
        sched.drain()
        worker = sched._thread
        assert worker is not None and worker.is_alive()
    assert sched._thread is None and not worker.is_alive()
    assert h.error is None

@pytest.mark.timeout(120)
def test_drain_waits_out_inflight_before_returning(problems):
    """drain() must not return while a wave is still on the worker —
    the completion count includes every submitted request."""
    with PipelinedScheduler(wave_size=1, max_in_flight=2) as sched:
        handles = [sched.submit(SolveRequest(
            problems["rastrigin"], seed=600 + i, max_iters=MAX_ITERS))
            for i in range(5)]
        done = sched.drain()
        assert done == 5 and sched.in_flight == 0
        assert all(h.done() for h in handles)
        t0 = time.perf_counter()
        assert sched.drain() == 0, "an idle drain returns immediately"
        assert time.perf_counter() - t0 < 5.0

# ---------------------------------------------------------------------------
# chaos
# ---------------------------------------------------------------------------


@pytest.mark.timeout(240)
def test_chaos_mixed_faults_all_handles_terminate_bitwise(problems):
    """ACCEPTANCE: 25% dispatch errors + 25% latency spikes + a poison
    request + a persistently-corrupting request, all at once.  Every
    handle terminates; completions match the fault-free run bitwise."""
    plan = FaultPlan(seed=7, dispatch_error_rate=0.25, latency_rate=0.25,
                     latency_s=0.002, error_dispatches={1},
                     latency_dispatches={3}, max_failures=8)
    sched = Scheduler(wave_size=4, faults=plan, max_retries=2,
                      retry_backoff_s=0.001, backoff_cap_s=0.01)
    reqs = [SolveRequest(problems["rastrigin" if i % 3 else "quadratic"],
                         seed=100 + i, max_iters=MAX_ITERS)
            for i in range(12)]
    handles = [sched.submit(r) for r in reqs]
    # scripted per-request faults on real sequence numbers: one poison
    # (fails every wave containing it) + one persistent result corruptor
    plan.poison_seqs = frozenset({handles[5].seq})
    plan.nonfinite_seqs = frozenset({handles[8].seq})
    sched.drain()

    assert all(h.done() for h in handles), "every handle terminates"
    assert plan.injected_errors >= 1 and plan.injected_poison >= 1
    poisoned = handles[5]
    assert isinstance(poisoned.error, DispatchFailed)
    assert isinstance(poisoned.error.__cause__, PoisonError)
    corrupted = handles[8]
    assert corrupted.error is None
    assert corrupted.result().extras["finite"] is False
    assert np.isnan(float(corrupted.result().best_f))
    for i, (h, req) in enumerate(zip(handles, reqs)):
        if i in (5, 8):
            continue
        # survivors may have ridden failed/bisected/padded waves — the
        # math must not know: bitwise parity with the fault-free path
        assert h.error is None, h
        _assert_handle_bitwise(h, _fault_free(req))
    m = sched.metrics()
    assert m["fault_injections"] == plan.injected > 0
    assert m["completed"] == 11 and m["failed"] == 1

@pytest.mark.timeout(240)
def test_chaos_mixed_faults_pipelined_scheduler(problems):
    """The ACCEPTANCE chaos run through the PIPELINED scheduler: faults
    now surface on two threads (submit-side on the scheduler thread,
    fetch-side on the dispatch worker), and the same contract holds —
    every handle terminates, completions are bitwise fault-free."""
    plan = FaultPlan(seed=7, dispatch_error_rate=0.25, latency_rate=0.25,
                     latency_s=0.002, error_dispatches={1},
                     latency_dispatches={3}, max_failures=8)
    with PipelinedScheduler(wave_size=4, max_in_flight=2, faults=plan,
                            max_retries=2, retry_backoff_s=0.001,
                            backoff_cap_s=0.01) as sched:
        reqs = [SolveRequest(
            problems["rastrigin" if i % 3 else "quadratic"],
            seed=100 + i, max_iters=MAX_ITERS) for i in range(12)]
        handles = [sched.submit(r) for r in reqs]
        plan.poison_seqs = frozenset({handles[5].seq})
        plan.nonfinite_seqs = frozenset({handles[8].seq})
        sched.drain()

    assert all(h.done() for h in handles), "every handle terminates"
    assert plan.injected_errors >= 1 and plan.injected_poison >= 1
    poisoned = handles[5]
    assert isinstance(poisoned.error, DispatchFailed)
    assert isinstance(poisoned.error.__cause__, PoisonError)
    corrupted = handles[8]
    assert corrupted.error is None
    assert corrupted.result().extras["finite"] is False
    for i, (h, req) in enumerate(zip(handles, reqs)):
        if i in (5, 8):
            continue
        assert h.error is None, h
        _assert_handle_bitwise(h, _fault_free(req))
    m = sched.metrics()
    assert m["fault_injections"] == plan.injected > 0
    assert m["completed"] == 11 and m["failed"] == 1

@pytest.mark.timeout(120)
def test_expired_requests_never_occupy_wave_slots(problems):
    sched = Scheduler(wave_size=4)
    doomed = [sched.submit(SolveRequest(problems["rastrigin"], seed=s,
                                        max_iters=MAX_ITERS,
                                        deadline_s=0.001))
              for s in (1, 2)]
    live = [sched.submit(SolveRequest(problems["rastrigin"], seed=s,
                                      max_iters=MAX_ITERS))
            for s in (3, 4)]
    time.sleep(0.01)                        # both deadlines lapse queued
    sched.drain()
    for h in doomed:
        assert h.done() and isinstance(h.error, DeadlineExceeded)
        with pytest.raises(DeadlineExceeded):
            h.result()
    for h in live:
        assert h.done() and h.error is None
    m = sched.metrics()
    assert m["expired"] == 2
    # the proof: one wave, exactly the two live requests in its active
    # slots — the expired pair held no slot (padding is inactive slots)
    assert m["waves"] == 1
    assert m["slots"] - m["padded_slots"] == 2

@pytest.mark.timeout(120)
def test_deadline_aware_bucket_selection(problems):
    """A deadline-carrying request's bucket is served ahead of the
    front-of-queue bucket, even when the front has higher priority."""
    q = RequestQueue()
    sched = Scheduler(q, wave_size=2)
    q.submit(SolveRequest(problems["rastrigin"], seed=1, priority=5))
    urgent = q.submit(SolveRequest(problems["quadratic"], seed=2,
                                   deadline_s=60.0))
    bucket = q.pop_bucket(2, key=sched.signature, token=sched)
    assert bucket == [urgent]

def test_result_wait_respects_deadline(problems):
    """result() on an in-flight handle fails at the deadline instead of
    blocking past it (nobody is serving this queue)."""
    q = RequestQueue()
    h = q.submit(SolveRequest(problems["rastrigin"], deadline_s=0.02))
    t0 = time.perf_counter()
    with pytest.raises(DeadlineExceeded):
        h.result()
    assert time.perf_counter() - t0 < 5.0
    assert h.done()

def test_admission_reject(problems):
    q = RequestQueue(capacity=2)
    q.submit(SolveRequest(problems["rastrigin"], seed=1))
    q.submit(SolveRequest(problems["rastrigin"], seed=2))
    with pytest.raises(QueueFull):
        q.submit(SolveRequest(problems["rastrigin"], seed=3))
    assert len(q) == 2 and q.rejected == 1

def test_admission_shed_lowest_priority(problems):
    q = RequestQueue(capacity=2, admission="shed-lowest-priority")
    keep = q.submit(SolveRequest(problems["rastrigin"], seed=1, priority=3))
    victim = q.submit(SolveRequest(problems["rastrigin"], seed=2,
                                   priority=0))
    hi = q.submit(SolveRequest(problems["rastrigin"], seed=3, priority=5))
    # the lowest-priority queued request was evicted, ITS handle failed
    assert victim.done() and isinstance(victim.error, QueueFull)
    assert q.shed == 1 and len(q) == 2
    assert q.pop_bucket(2) == [hi, keep]
    # an arrival that does not beat the lowest queued priority is itself
    # the victim: rejected, nothing evicted
    q2 = RequestQueue(capacity=1, admission="shed-lowest-priority")
    q2.submit(SolveRequest(problems["rastrigin"], seed=4, priority=1))
    with pytest.raises(QueueFull):
        q2.submit(SolveRequest(problems["rastrigin"], seed=5, priority=1))
    assert q2.rejected == 1 and q2.shed == 0 and len(q2) == 1

def test_admission_block_backpressure(problems):
    q = RequestQueue(capacity=1, admission="block", block_timeout_s=0.05)
    q.submit(SolveRequest(problems["rastrigin"], seed=1))
    # no consumer: the blocked submit times out into QueueFull
    with pytest.raises(QueueFull):
        q.submit(SolveRequest(problems["rastrigin"], seed=2))
    assert q.rejected == 1
    # with a consumer freeing a slot, the blocked submitter gets through
    q2 = RequestQueue(capacity=1, admission="block", block_timeout_s=5.0)
    q2.submit(SolveRequest(problems["rastrigin"], seed=3))
    popper = threading.Timer(0.02, lambda: q2.pop_bucket(1))
    popper.start()
    try:
        h = q2.submit(SolveRequest(problems["rastrigin"], seed=4))
    finally:
        popper.join(timeout=10)
    assert not popper.is_alive()
    assert not h.done() and len(q2) == 1

def test_expired_requests_do_not_hold_capacity(problems):
    """Admission purges expired entries before refusing an arrival."""
    q = RequestQueue(capacity=1)
    dead = q.submit(SolveRequest(problems["rastrigin"], seed=1,
                                 deadline_s=0.001))
    time.sleep(0.01)
    fresh = q.submit(SolveRequest(problems["rastrigin"], seed=2))
    assert isinstance(dead.error, DeadlineExceeded)
    assert q.expired == 1 and q.rejected == 0
    assert q.pop_bucket(1) == [fresh]

@pytest.mark.timeout(120)
def test_backoff_sleeps_instead_of_spinning(problems):
    sched = Scheduler(wave_size=2, injector=FailureInjector(rate=1.0),
                      max_retries=2, retry_backoff_s=0.01,
                      backoff_cap_s=0.05, seed=3)
    h = sched.submit(SolveRequest(problems["rastrigin"], seed=9,
                                  max_iters=MAX_ITERS))
    t0 = time.perf_counter()
    sched.drain()
    elapsed = time.perf_counter() - t0
    assert h.done() and isinstance(h.error, DispatchFailed)
    assert isinstance(h.error.__cause__, SimulatedFailure)
    # exactly initial + max_retries dispatches — backoff gated the loop
    # to 3 attempts, no hot-spin burning dispatches between releases
    assert sched._dispatches == 3
    m = sched.metrics()
    assert m["failed_waves"] == 3 and m["backoff_s"] > 0
    assert elapsed >= m["backoff_s"] * 0.5

@pytest.mark.timeout(120)
def test_faultplan_max_failures_allows_recovery(problems):
    """rate=1.0 capped at 2 injections: the request rides out both
    failures on its retry budget and then completes normally."""
    plan = FaultPlan(seed=1, dispatch_error_rate=1.0, max_failures=2)
    sched = Scheduler(wave_size=2, faults=plan, max_retries=2,
                      retry_backoff_s=0.0)
    req = SolveRequest(problems["rastrigin"], seed=17, max_iters=MAX_ITERS)
    h = sched.submit(req)
    assert sched.drain() == 1
    assert h.error is None and h.retries == 2
    assert plan.injected_errors == 2
    _assert_handle_bitwise(h, _fault_free(req))

@pytest.mark.timeout(240)
def test_quarantine_bisection_isolates_poison(problems):
    plan = FaultPlan(seed=0)
    sched = Scheduler(wave_size=4, faults=plan, max_retries=2,
                      retry_backoff_s=0.0)
    reqs = [SolveRequest(problems["rastrigin"], seed=40 + i,
                         max_iters=MAX_ITERS) for i in range(4)]
    handles = [sched.submit(r) for r in reqs]
    plan.poison_seqs = frozenset({handles[2].seq})
    sched.drain()
    poisoned = handles[2]
    assert isinstance(poisoned.error, DispatchFailed)
    assert isinstance(poisoned.error.__cause__, PoisonError)
    assert poisoned.error.__cause__.seq == poisoned.seq
    # the poison burned ONLY its own budget: charged retries happen at
    # unsplittable width-1 probes, so the mates rode the failed waves
    # for free and completed with untouched budgets
    for i, h in enumerate(handles):
        if i == 2:
            continue
        assert h.error is None and h.retries == 0, h
        _assert_handle_bitwise(h, _fault_free(reqs[i]))
    m = sched.metrics()
    assert m["bisected_waves"] >= 1
    assert m["completed"] == 3 and m["failed"] == 1

@pytest.mark.timeout(120)
def test_quarantine_off_charges_whole_bucket(problems):
    """quarantine=False is the control: the whole bucket burns retries
    together and every member fails once the budget is gone."""
    plan = FaultPlan(seed=0)
    sched = Scheduler(wave_size=2, faults=plan, max_retries=1,
                      retry_backoff_s=0.0, quarantine=False)
    handles = [sched.submit(SolveRequest(problems["rastrigin"], seed=50 + i,
                                         max_iters=MAX_ITERS))
               for i in range(2)]
    plan.poison_seqs = frozenset({handles[0].seq})
    sched.drain()
    for h in handles:
        assert isinstance(h.error, DispatchFailed)
        assert h.retries == 2

@pytest.mark.timeout(120)
def test_scheduler_on_nonfinite_raise_fails_only_that_handle(problems):
    plan = FaultPlan(seed=0)
    sched = Scheduler(wave_size=2, faults=plan, on_nonfinite="raise",
                      retry_backoff_s=0.0)
    reqs = [SolveRequest(problems["rastrigin"], seed=60 + i,
                         max_iters=MAX_ITERS) for i in range(2)]
    handles = [sched.submit(r) for r in reqs]
    plan.nonfinite_seqs = frozenset({handles[0].seq})
    sched.drain()
    assert isinstance(handles[0].error, NonFiniteResult)
    assert np.isnan(float(handles[0].error.result.best_f))
    assert handles[1].error is None
    _assert_handle_bitwise(handles[1], _fault_free(reqs[1]))
    m = sched.metrics()
    assert m["nonfinite_results"] == 1 and m["failed"] == 1

def test_faultplan_is_deterministic_and_seeded():
    a = FaultPlan(seed=11, dispatch_error_rate=0.5, nonfinite_rate=0.5)
    b = FaultPlan(seed=11, dispatch_error_rate=0.5, nonfinite_rate=0.5)
    c = FaultPlan(seed=12, dispatch_error_rate=0.5, nonfinite_rate=0.5)
    rolls_a = [a.corrupts_result(s) for s in range(200)]
    rolls_b = [b.corrupts_result(s) for s in range(200)]
    rolls_c = [c.corrupts_result(s) for s in range(200)]
    assert rolls_a == rolls_b                   # same seed -> same plan
    assert rolls_a != rolls_c                   # seeded, not degenerate
    assert 60 <= sum(rolls_a) <= 140            # ~Bernoulli(0.5)
    # dispatch decisions are index-keyed, not call-order-keyed: polling
    # out of order (retries interleave) changes nothing
    fires = []
    for plan in (FaultPlan(seed=3, dispatch_error_rate=0.5),
                 FaultPlan(seed=3, dispatch_error_rate=0.5)):
        seen = []
        order = list(range(50))
        if fires:                               # second pass: shuffled
            order = order[::-1]
        for i in order:
            try:
                plan.before_dispatch(i, frozenset())
                seen.append((i, False))
            except SimulatedFailure:
                seen.append((i, True))
        fires.append(dict(seen))
    assert fires[0] == fires[1]

def test_faultplan_latency_spike_is_visible():
    plan = FaultPlan(seed=0, latency_dispatches={1}, latency_s=0.03)
    t0 = time.perf_counter()
    plan.before_dispatch(1, frozenset())
    spiked = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan.before_dispatch(2, frozenset())
    clean = time.perf_counter() - t0
    assert spiked >= 0.03 > clean
    assert plan.injected_latency == 1

# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------


def test_straggler_policy_masks_and_recovers():
    pol = StragglerPolicy(n_shards=4, factor=2.0, cooldown=2)
    times = np.asarray([1.0, 1.0, 1.0, 10.0])
    mask = pol.update(times)
    assert mask.tolist() == [True, True, True, False]
    mask = pol.update(np.ones(4))
    assert mask.tolist() == [True, True, True, False]   # cooldown
    mask = pol.update(np.ones(4))
    assert mask.tolist() == [True, True, True, True]    # recovered

def test_straggler_cooldown_expiry_restores_full_quorum():
    """quorum_fraction returns exactly to 1.0 once every masked shard's
    cooldown expires — the serving scheduler keys its wave width off it,
    so a fraction stuck below 1.0 would shrink waves forever."""
    pol = StragglerPolicy(n_shards=4, factor=2.0, cooldown=3)
    pol.update(np.asarray([1.0, 1.0, 1.0, 10.0]))
    assert pol.quorum_fraction == 0.75
    for _ in range(pol.cooldown - 1):
        pol.update(np.ones(4))
        assert pol.quorum_fraction < 1.0        # still cooling down
    pol.update(np.ones(4))
    assert pol.quorum_fraction == 1.0           # exact, not approx

def test_drop_shard_on_minimal_quorum():
    """Dropping the last alive shard must refuse, not return an empty
    quorum (an all-False mask would make the device reduce meaningless)."""
    import pytest

    from repro_torch.runtime.elastic import drop_shard

    mask = drop_shard(np.asarray([True, True, False, False]))
    assert np.asarray(mask).tolist() == [False, True, False, False]
    minimal = np.asarray([False, True, False, False])
    with pytest.raises(RuntimeError, match="empties the quorum"):
        drop_shard(minimal)
    with pytest.raises(RuntimeError, match="empties the quorum"):
        drop_shard(minimal, victim=1)
    with pytest.raises(RuntimeError, match="quorum already empty"):
        drop_shard(np.zeros(4, bool))
    # the refused drops left the caller's mask untouched (copy semantics)
    assert minimal.tolist() == [False, True, False, False]

def test_elastic_plan_matches_paper_formula():
    plan = elastic_population_plan(n_bits=63, n_shards=64)
    assert plan["population"] == 125
    assert plan["children_per_shard"] == 2     # ceil(125/64)
    plan = elastic_population_plan(n_bits=63, n_shards=48)
    assert plan["children_per_shard"] == 3

# ---------------------------------------------------------------------------
# launch/serve.py --dgo, on the CPU (in a subprocess with a time limit)
# ---------------------------------------------------------------------------

SERVE_CLI = r"""
import contextlib, io, json, sys
from repro_torch.launch import serve

out = []
for argv in json.loads(sys.argv[1]):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rep = serve.serve_dgo(serve.build_parser().parse_args(argv),
                              device="cpu")
    printed = [json.loads(line) for line in buf.getvalue().splitlines()]
    out.append({"report": rep, "printed": printed})
print(json.dumps(out))
"""


def _serve_cli(*argvs):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    run = subprocess.run([sys.executable, "-c", SERVE_CLI,
                          json.dumps([list(a) for a in argvs])],
                         capture_output=True, text=True, env=env,
                         timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def test_serve_dgo_closed_loop_pipelined_and_not():
    """``serve --dgo`` in closed loop, pipelined and synchronous: every
    request completes, the report is printed as the last line, and both
    find the same best value; then an open-loop run, a saturation sweep
    and a run under a fault plan."""
    base = ("--dgo", "--problems", "rastrigin:2,shekel", "--restarts", "4",
            "--waves", "2", "--max-iters", "8")
    piped, sync, open_loop, sweep, chaos = _serve_cli(
        base, base + ("--no-pipeline",),
        ("--dgo", "--problem", "quadratic", "--n-vars", "3", "--rps", "200",
         "--duration", "0.3", "--restarts", "4", "--max-iters", "8"),
        ("--dgo", "--problem", "rastrigin", "--n-vars", "2",
         "--sweep-rps", "100,400", "--duration", "0.2", "--restarts", "4",
         "--max-iters", "8"),
        base + ("--fault-rate", "0.5", "--fault-seed", "3",
                "--retry-backoff-s", "0"))
    for run in (piped, sync):
        rep = run["report"]
        assert run["printed"][-1] == rep
        assert rep["completed"] == 8 and rep["failed"] == 0
        assert rep["problems"] == ["rastrigin2d", "shekel5"]
        assert rep["waves"] == 2 and rep["bucket_fill"] == 1.0
        assert rep["cache_engines_built"] == 2 and rep["checkpoints"] == []
    assert piped["report"]["best_value"] == sync["report"]["best_value"]
    rep = open_loop["report"]
    assert rep["completed"] >= 1 and rep["failed"] == 0
    assert rep["latency_p99_ms"] >= rep["latency_p50_ms"] > 0
    summary = sweep["report"]
    assert summary["sweep_rps"] == [100.0, 400.0]
    assert [row["rps"] for row in summary["sweep"]] == [100.0, 400.0]
    assert sweep["printed"][-1] == summary and len(sweep["printed"]) == 3
    rep = chaos["report"]
    assert rep["fault_injections"] >= 1
    assert rep["completed"] + rep["failed"] == 8


def test_serve_dgo_checks_its_flags(tmp_path):
    from repro_torch.launch import serve

    def args(*argv):
        return serve.build_parser().parse_args(["--dgo", *argv])

    with pytest.raises(SystemExit, match="unknown objective"):
        serve.serve_dgo(args("--problems", "warp-drive"), device="cpu")
    with pytest.raises(SystemExit, match=r"must be in \[1, 1024\]"):
        serve.serve_dgo(args("--problems", "rastrigin:0"), device="cpu")
    with pytest.raises(SystemExit, match="--rps must be > 0"):
        serve.serve_dgo(args("--rps", "0"), device="cpu")
    # every architecture's tuning problem serves, xLSTM's included
    rep = serve.serve_dgo(args("--problems", "subspace-lm:xlstm-125m",
                               "--restarts", "1", "--waves", "1",
                               "--max-iters", "2"), device="cpu")
    assert rep["problems"] == ["subspace-lm:xlstm-125m"]
    assert rep["completed"] == 1 and np.isfinite(rep["best_value"])
    # --ckpt-dir persists tuning winners only: none among paper problems
    rep = serve.serve_dgo(args("--ckpt-dir", str(tmp_path), "--problem",
                               "rastrigin", "--n-vars", "2", "--restarts",
                               "2", "--waves", "1", "--max-iters", "4"),
                          device="cpu")
    assert rep["completed"] == 2 and rep["checkpoints"] == []
    specs = serve._parse_problem_specs(args("--problems",
                                            "rastrigin:3, shekel,,ackley:5"))
    assert [p.name for p in specs] == ["rastrigin3d", "shekel5", "ackley5d"]
    assert serve._parse_problem_specs(args("--problem", "quadratic",
                                           "--n-vars", "4"))[0] \
        is Problem.get("quadratic", n=4)
