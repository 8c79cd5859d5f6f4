"""The serving scheduler: signature-bucketed continuous batching over the
batched DGO engine (``repro.serving.scheduler``, ported).

One :meth:`Scheduler.run_wave` is the unit of work: pop up to
``wave_size`` queued requests sharing one engine-cache signature
(:func:`repro_torch.core.solver.engine_signature` — problem spec +
encoding + resolution schedule + mesh geometry), pad the bucket to the
wave width with inactive slots, and dispatch it through
:func:`repro_torch.core.solver.solve_many` as one wave of the batched
engine (on the card, one popstep launch a step for every live slot).
Per-request results are bitwise identical to fault-free individual solves
(the engine's per-slot independence), so batching is purely a throughput
decision.  ``device`` (None: the card; ``"cpu"``: the plain versions)
applies to every wave.

Fault tolerance is part of the loop, not bench-only code:

* **retry + backoff** — a dispatch that raises (a real error, an
  injected ``runtime.failure.FailureInjector`` step failure, or a
  ``runtime.failure.FaultPlan`` fault) requeues its requests; the failed
  signature bucket enters exponential backoff with jitter
  (``retry_backoff_s`` doubling per consecutive failure up to
  ``backoff_cap_s``), and :meth:`drain` SLEEPS until the earliest release
  instead of spinning hot on a persistent failure;
* **poison quarantine** — a failed multi-request wave is bisected on
  retry (half the bucket per probe, down to single-request waves), so
  one poison request fails ALONE in ≤ log2(W) probes; bucket members are
  only charged a retry when their wave could not be split further, so a
  poison does not burn its wave-mates' retry budgets;
* **per-handle failure** — a request out of retries fails its handle
  with its OWN ``DispatchFailed`` (chained from the dispatch error via
  ``__cause__``), never a shared exception instance;
* **deadlines** — expired requests are failed at pop time by the queue
  (``DeadlineExceeded``), so no wave is ever dispatched containing one,
  and bucket selection is deadline-aware (earliest-deadline bucket ahead
  of front-of-queue greedy);
* **result hygiene** — non-finite results (``extras["finite"]`` from
  ``solve_many``) are counted, and under ``on_nonfinite="raise"`` fail
  their OWN handle with ``NonFiniteResult`` without touching wave-mates.

A ``runtime.straggler.StragglerPolicy`` can feed the wave-size choice:
recent dispatch times are treated as virtual lanes, and when some
straggle past the policy's factor the next waves shrink (smaller
dispatches under contention) until the cooldown expires.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core import spans
from repro_torch.core.solver import (
    NonFiniteResult, SolveRequest, engine_signature, solve_many,
)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.queue import (
    DispatchFailed, RequestHandle, RequestQueue)


def warmup(problems: Iterable, *, wave_size: int = 8, mesh=None,
           pop_axes: Sequence[str] = ("data",), virtual_block: int = 256,
           max_bits: int | None = None, bits_step: int = 2,
           max_iters: int | None = None, device=None) -> int:
    """One throwaway full-width dispatch per distinct engine signature.

    The shared warm-up helper (CLI and scheduler use it): after it
    returns, steady-state waves of the same problems / ``max_iters`` /
    ``wave_size`` find their engine in the ``distributed.engine`` cache,
    its steps bound and the kernel built, instead of paying for them
    inside a latency measurement.  Returns the number of engines warmed.
    """
    seen: dict[tuple, SolveRequest] = {}
    for p in problems:
        req = (p if isinstance(p, SolveRequest)
               else SolveRequest(problem=p, max_iters=max_iters)).resolve()
        sig = engine_signature(req.problem, mesh=mesh, pop_axes=pop_axes,
                               virtual_block=virtual_block,
                               max_bits=max_bits, bits_step=bits_step)
        seen.setdefault(sig, req)
    for req in seen.values():
        solve_many([req], mesh=mesh, pop_axes=pop_axes,
                   virtual_block=virtual_block, max_bits=max_bits,
                   bits_step=bits_step, pad_to=wave_size, device=device)
    return len(seen)


def _check_deadline(end: float | None) -> None:
    if end is not None and time.perf_counter() > end:
        raise TimeoutError("the scheduler did not drain in time")


class Scheduler:
    """Pulls signature buckets off a :class:`RequestQueue` and serves
    them through the batched engine.

    Parameters: ``wave_size`` — the restart width buckets are padded to
    (the engine's R); ``mesh``/``pop_axes``/``virtual_block`` —
    the dispatch geometry (default: all local devices on ``("data",)``);
    ``max_bits``/``bits_step`` — optional folded resolution schedule
    applied to every request; ``max_retries`` — CHARGED dispatch retries
    per request before its handle fails (quarantine probes of splittable
    buckets are uncharged); ``injector`` — optional ``FailureInjector``
    polled once per dispatch; ``faults`` — optional
    ``runtime.failure.FaultPlan`` polled around every dispatch (chaos
    harness); ``straggler`` — optional ``StragglerPolicy`` fed with
    recent dispatch times; ``retry_backoff_s``/``backoff_cap_s``/
    ``backoff_jitter`` — exponential-backoff shape for failing buckets
    (base doubling per consecutive failure, multiplicative jitter drawn
    from a ``seed``-ed rng; ``retry_backoff_s=0`` disables);
    ``quarantine`` — bisect failed multi-request waves on retry;
    ``on_nonfinite`` — ``"flag"`` (default) completes non-finite results
    flagged, ``"raise"`` fails their handles with ``NonFiniteResult``;
    ``device`` — where the waves run (None: the CUDA card).
    """

    def __init__(self, queue: RequestQueue | None = None, *,
                 wave_size: int = 8, mesh=None,
                 pop_axes: Sequence[str] = ("data",),
                 virtual_block: int = 256, max_bits: int | None = None,
                 bits_step: int = 2, max_retries: int = 2,
                 injector=None, faults=None, straggler=None,
                 retry_backoff_s: float = 0.05,
                 backoff_cap_s: float = 2.0,
                 backoff_jitter: float = 0.25,
                 quarantine: bool = True,
                 on_nonfinite: str = "flag",
                 seed: int = 0, device=None):
        if wave_size < 1:
            raise ValueError(f"wave_size must be >= 1, got {wave_size}")
        if retry_backoff_s < 0:
            raise ValueError(f"retry_backoff_s must be >= 0, "
                             f"got {retry_backoff_s}")
        if on_nonfinite not in ("flag", "raise"):
            raise ValueError(f"on_nonfinite must be 'flag' or 'raise', "
                             f"got {on_nonfinite!r}")
        self.queue = queue if queue is not None else RequestQueue()
        self.wave_size = wave_size
        self.mesh = mesh
        self.pop_axes = tuple(pop_axes)
        self.virtual_block = virtual_block
        self.max_bits = max_bits
        self.bits_step = bits_step
        self.max_retries = max_retries
        self.injector = injector
        self.faults = faults
        self.straggler = straggler
        self.retry_backoff_s = retry_backoff_s
        self.backoff_cap_s = backoff_cap_s
        self.backoff_jitter = backoff_jitter
        self.quarantine = quarantine
        self.on_nonfinite = on_nonfinite
        self.device = device
        self.metrics_ = ServingMetrics()
        self._dispatches = 0
        self._jitter_rng = np.random.default_rng(seed)
        # per-signature retry state: consecutive dispatch failures and
        # the not-before release time (exponential backoff), plus the
        # quarantine bisection width for the next probe of the bucket
        self._backoff: dict[tuple, tuple[int, float]] = {}
        self._bisect: dict[tuple, int] = {}
        self._last_popped = False
        self._recent = deque(
            maxlen=straggler.n_shards if straggler is not None else 1)

    # -- submission --------------------------------------------------------

    def submit(self, request, **kwargs) -> RequestHandle:
        """Enqueue a request (see :meth:`RequestQueue.submit`)."""
        return self.queue.submit(request, **kwargs)

    def signature(self, request: SolveRequest) -> tuple:
        """The engine-cache bucket key of ``request`` under this
        scheduler's dispatch configuration."""
        return engine_signature(
            request.problem, mesh=self.mesh, pop_axes=self.pop_axes,
            virtual_block=self.virtual_block, max_bits=self.max_bits,
            bits_step=self.bits_step)

    # -- wave sizing -------------------------------------------------------

    def effective_wave_size(self) -> int:
        """The next wave's width: ``wave_size`` scaled by the straggler
        policy's live-lane fraction (recent dispatch times past
        ``factor`` x median mask their lanes for ``cooldown`` rounds —
        under contention the scheduler dispatches smaller waves).

        Widths snap to halvings of ``wave_size`` (W, W/2, W/4, ..., 1):
        each distinct width is its own engine (and its own bound steps)
        per signature, so a free-form shrink would answer one slow
        dispatch with a chain of engine builds as the cooldown decays —
        halving bounds the widths to log2(W) per signature."""
        if self.straggler is None:
            return self.wave_size
        target = max(1, int(round(
            self.wave_size * self.straggler.quorum_fraction)))
        width = self.wave_size
        while width > target:
            width = max(1, width // 2)
        return width

    def _snap_width(self, n: int) -> int:
        """Smallest halving of ``wave_size`` that fits ``n`` requests —
        bisected probe waves reuse the same bounded set of
        widths as straggler shrinks."""
        width = self.wave_size
        while width // 2 >= n and width > 1:
            width //= 2
        return width

    def _note_dispatch_time(self, elapsed_s: float) -> None:
        if self.straggler is None:
            return
        self._recent.append(elapsed_s)
        if len(self._recent) == self._recent.maxlen:
            self.straggler.update(np.asarray(self._recent, np.float64))

    # -- the serving loop --------------------------------------------------

    def warmup(self, problems: Iterable, max_iters: int | None = None) -> int:
        """Warm the engine cache for ``problems`` at this scheduler's
        configuration (shared helper, see :func:`warmup`)."""
        n = warmup(problems, wave_size=self.wave_size, mesh=self.mesh,
                   pop_axes=self.pop_axes, virtual_block=self.virtual_block,
                   max_bits=self.max_bits, bits_step=self.bits_step,
                   max_iters=max_iters, device=self.device)
        for _ in range(n):
            self.metrics_.record_warmup()
        return n

    # -- shared retry/bisect state access ----------------------------------
    # the pipelined scheduler (serving/pipeline.py) discovers failures on
    # its dispatch-worker thread, so every touch of the _backoff/_bisect
    # tables goes through these four hooks — the subclass wraps each in
    # its retry-state lock without duplicating the policy

    def _backoff_snapshot(self) -> dict:
        """Point-in-time copy of the per-signature backoff table."""
        return dict(self._backoff)

    def _bisect_limit(self, sig: tuple) -> int | None:
        """The armed quarantine-probe width for ``sig`` (None = none)."""
        return self._bisect.get(sig)

    def _note_success(self, sig: tuple) -> None:
        """A dispatch of ``sig`` succeeded: the bucket recovered."""
        self._backoff.pop(sig, None)
        self._bisect.pop(sig, None)

    def _note_failure(self, sig: tuple, n_bucket: int) -> bool:
        """A dispatch of ``sig`` failed: extend its exponential backoff
        and arm quarantine bisection when the bucket can still be split.
        Returns whether it could (splittable => members uncharged)."""
        fails = self._backoff.get(sig, (0, 0.0))[0] + 1
        delay = 0.0
        if self.retry_backoff_s > 0:
            delay = min(self.backoff_cap_s,
                        self.retry_backoff_s * (2.0 ** (fails - 1)))
            delay *= 1.0 + self.backoff_jitter * float(
                self._jitter_rng.random())
        self._backoff[sig] = (fails, time.perf_counter() + delay)
        splittable = self.quarantine and n_bucket > 1
        if splittable:
            self._bisect[sig] = (n_bucket + 1) // 2
        return splittable

    def _next_bucket(self) -> tuple[list[RequestHandle], int, tuple] | None:
        """Pop + shape the next dispatchable bucket: skip backed-off
        signatures, apply the armed quarantine-probe limit (excess
        members requeued), snap the width.  Returns
        ``(bucket, width, sig)`` or None when nothing is poppable."""
        now = time.perf_counter()
        blocked = {sig for sig, (_, release)
                   in self._backoff_snapshot().items() if release > now}
        width = self.effective_wave_size()
        bucket = self.queue.pop_bucket(width, key=self.signature,
                                       token=self, exclude=blocked)
        self._last_popped = bool(bucket)
        if not bucket:
            return None
        sig = bucket[0].signature
        limit = self._bisect_limit(sig)
        if limit is not None and len(bucket) > limit:
            # quarantine probe: retry only half of the failed bucket, so
            # a poison request is isolated in at most log2(W) probes
            for handle in bucket[limit:]:
                self.queue.requeue(handle)
            bucket = bucket[:limit]
            width = self._snap_width(limit)
            self.metrics_.record_bisect()
        return bucket, width, sig

    def _pop_wave(self):
        """Pop the next bucket (:meth:`_next_bucket`) into a wave and
        number it.  Returns ``(bucket, width, sig, wave)`` or None;
        ``wave`` is a :class:`~repro_torch.core.spans.Wave` when a profiler
        session records on this thread (the one check a wave), and its
        requests' queue waits are recorded here, else None."""
        traced = spans.profiling()
        popped_ns = spans.now() if traced else 0
        popped = self._next_bucket()
        if popped is None:
            return None
        self._dispatches += 1
        if not traced:
            return (*popped, None)
        wave = spans.Wave(self._dispatches, popped_ns)
        with spans.wave(wave):
            for handle in popped[0]:
                spans.record("serving.queue_wait",
                             spans.from_perf(handle.submitted_at), popped_ns,
                             request=handle.seq)
        return (*popped, wave)

    def _complete_bucket(self, bucket: list[RequestHandle],
                         results) -> int:
        """Terminal bookkeeping for one successful dispatch: apply the
        fault plan's result corruption, the per-handle non-finite policy,
        and complete the handles.  Returns the completion count."""
        if self.faults is not None:
            results = self.faults.corrupt_results(
                [h.seq for h in bucket], results)
        completed = 0
        for handle, result in zip(bucket, results):
            if not result.extras.get("finite", True):
                self.metrics_.record_nonfinite()
                if self.on_nonfinite == "raise":
                    handle._fail(NonFiniteResult(
                        f"request {handle.seq} produced a non-finite "
                        f"result", result))
                    self.metrics_.record_failure()
                    continue
            handle._complete(result)
            self.metrics_.record_completion(handle.latency_s)
            completed += 1
        return completed

    def run_wave(self) -> int:
        """Serve one signature bucket; returns the number of requests
        completed (0 when nothing was poppable — queue empty or every
        bucket in backoff — or the dispatch failed and was requeued)."""
        popped = self._pop_wave()
        if popped is None:
            return 0
        bucket, width, sig, wave = popped
        seqs = frozenset(h.seq for h in bucket)
        t0 = time.perf_counter()
        with spans.wave(wave):
            try:
                with spans.span("serving.submit",
                                start_ns=wave and wave.popped_ns):
                    if self.faults is not None:
                        self.faults.before_dispatch(self._dispatches, seqs)
                    if self.injector is not None:
                        self.injector.maybe_fail(self._dispatches)
                    results = solve_many(
                        [h.request for h in bucket], mesh=self.mesh,
                        pop_axes=self.pop_axes,
                        virtual_block=self.virtual_block,
                        max_bits=self.max_bits, bits_step=self.bits_step,
                        pad_to=width, device=self.device)
            except Exception as err:        # noqa: BLE001 — the serving
                # loop survives any dispatch failure by requeueing it
                self.metrics_.record_failed_wave(time.perf_counter() - t0)
                self._register_failure(sig, bucket, err)
                return 0
            elapsed = time.perf_counter() - t0
            with spans.span("serving.finalize"):
                self._note_success(sig)     # the bucket recovered
                completed = self._complete_bucket(bucket, results)
        self.metrics_.record_wave(len(bucket), width, elapsed)
        self.metrics_.record_inflight(1)    # synchronous: depth always 1
        self._note_dispatch_time(elapsed)
        return completed

    def step(self) -> bool:
        """Advance the serving loop by one unit of work; returns whether
        a bucket was dispatched (successfully or not).  The serving CLI's
        loop primitive: the synchronous scheduler blocks for one whole
        wave here, the pipelined scheduler overrides this with a
        non-blocking assemble-and-submit (``PipelinedScheduler.pump``)."""
        self.run_wave()
        return self._last_popped

    def close(self) -> None:
        """Release scheduler resources.  No-op for the synchronous
        scheduler; the pipelined scheduler stops and joins its dispatch
        worker.  Call sites treat both uniformly."""

    def backoff_wait_s(self) -> float:
        """Seconds until the earliest backed-off bucket releases (0.0
        when none is pending)."""
        now = time.perf_counter()
        waits = [release - now
                 for _, release in self._backoff_snapshot().values()
                 if release > now]
        return min(waits) if waits else 0.0

    def drain(self, timeout_s: float | None = None) -> int:
        """Serve until the queue is empty (retries included); returns the
        number of requests completed.  When every queued bucket is in
        retry backoff, SLEEPS until the earliest release instead of
        spinning hot on a persistent failure.  ``timeout_s`` bounds the
        wall time (``TimeoutError`` past it, checked between waves)."""
        done = 0
        end = None if timeout_s is None else time.perf_counter() + timeout_s
        while len(self.queue):
            _check_deadline(end)
            done += self.run_wave()
            if not self._last_popped and len(self.queue):
                wait = self.backoff_wait_s()
                if wait > 0:
                    self.metrics_.record_backoff(wait)
                    time.sleep(wait)
        return done

    def _register_failure(self, sig: tuple, bucket: list[RequestHandle],
                          err: BaseException) -> None:
        """One failed dispatch of ``sig``'s bucket: extend the bucket's
        exponential backoff, arm quarantine bisection for the retry, and
        requeue/fail the members (see :meth:`_requeue_failed`)."""
        splittable = self._note_failure(sig, len(bucket))
        self._requeue_failed(bucket, err, charge=not splittable)

    def _requeue_failed(self, bucket: list[RequestHandle],
                        err: BaseException, charge: bool = True) -> None:
        """Retry accounting: every request of a failed dispatch goes back
        on the queue until it runs out of charged retries, then its
        handle fails with its OWN :class:`DispatchFailed` chained from
        the dispatch error.  ``charge=False`` (a quarantine probe of a
        bucket that can still be split) requeues without touching retry
        budgets — the bisection, not the members, absorbs the failure."""
        for handle in bucket:
            if charge:
                handle.retries += 1
            if handle.retries > self.max_retries:
                wrapped = DispatchFailed(handle.seq, handle.retries, err)
                wrapped.__cause__ = err
                handle._fail(wrapped)
                self.metrics_.record_failure()
            else:
                self.queue.requeue(handle)
                self.metrics_.record_requeue()

    # -- observability -----------------------------------------------------

    def metrics(self) -> dict:
        """The serving metrics snapshot (latency percentiles, counters,
        bucket fill, cache stats) plus scheduler + queue lifecycle state
        (admission/deadline/backoff/quarantine counters)."""
        out = self.metrics_.snapshot()
        out["wave_size"] = self.wave_size
        out["effective_wave_size"] = self.effective_wave_size()
        out["pending"] = len(self.queue)
        out["expired"] = self.queue.expired
        out["rejected"] = self.queue.rejected
        out["shed"] = self.queue.shed
        out["buckets_in_backoff"] = sum(
            1 for _, release in self._backoff_snapshot().values()
            if release > time.perf_counter())
        if self.straggler is not None:
            out["straggler_quorum_fraction"] = \
                self.straggler.quorum_fraction
        if self.injector is not None:
            out["injected_failures"] = self.injector.injected
        if self.faults is not None:
            out["fault_injections"] = self.faults.injected
        return out
