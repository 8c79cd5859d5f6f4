"""Pipelined serving: overlap host-side bucket assembly with device waves
(``repro.serving.pipeline``, ported).

The synchronous :class:`~repro_torch.serving.scheduler.Scheduler`
serializes every wave end to end — pop, assemble, dispatch, BLOCK on
results, complete — so the card sits idle while the host pops the next
bucket and post-processes the last one.
:func:`repro_torch.core.solver.submit_wave` splits a wave in two: it
returns once the wave's stepped loop is running on a worker thread (on
its own CUDA stream), and ``PendingWave.finalize()`` joins it.

:class:`PipelinedScheduler` uses the split with TWO threads of its own:

* the **scheduler thread** (whoever calls :meth:`pump`/:meth:`drain`)
  assembles buckets and SUBMITS them — pop, quarantine-probe shaping,
  fault-plan polling, start-point derivation, the wave's start — then
  hands the pending wave to the worker;
* the **dispatch worker** finalizes waves in submission order: it waits
  for each wave's results, completes/fails the handles, and runs the
  retry/backoff/bisection bookkeeping for failures that surface there.

With ``max_in_flight=2`` (double-buffering, the default) the scheduler
thread assembles and submits wave N+1 while wave N still runs, each wave
on its own stream.

Lock/ownership map:

==================  ====================================================
state               ownership / guarding lock
==================  ====================================================
``_inflight``,      ``self._flight`` (Condition): the submission FIFO,
``_stopping``,      the stop flag, and the worker-crash latch — touched
``_worker_error``   by both threads, always under the condition.
``_backoff``,       ``self._retry_lock``: read at pop time (scheduler
``_bisect``         thread), written on success/failure (either thread).
                    Base-class policy code runs inside the four
                    ``_note_*`` / snapshot hooks, each wrapped here with
                    the lock.
``_dispatches``,    scheduler thread only (single submitter): dispatch
``queue`` pops,     indices are assigned at submission in pop order, so
fault-plan polls    ``FaultPlan`` decisions stay deterministic under
                    threading.
``metrics_``        split by counter: wave/completion/failure counters
                    are written by whichever thread finalizes, bisect/
                    backoff/inflight by the scheduler thread; each
                    counter has one writer.
``_thread``         scheduler (control) thread only, via
                    :meth:`start`/:meth:`close`.
==================  ====================================================

Completions are bitwise identical to the synchronous path: both run the
same ``submit_wave``/``finalize`` compute — the pipeline only reorders
WHEN the host waits, never what the card computes.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from repro_torch.core import spans
from repro_torch.core.solver import submit_wave
from repro_torch.serving.scheduler import Scheduler, _check_deadline


class _InFlight:
    """One submitted-but-unfinalized wave, queued for the worker in
    dispatch order."""

    __slots__ = ("bucket", "width", "sig", "pending", "t0", "wave")

    def __init__(self, bucket, width, sig, pending, t0, wave):
        self.bucket = bucket
        self.width = width
        self.sig = sig
        self.pending = pending
        self.t0 = t0
        self.wave = wave        # spans.Wave when traced, else None


class PipelinedScheduler(Scheduler):
    """A :class:`~repro.serving.scheduler.Scheduler` that keeps up to
    ``max_in_flight`` waves on device while the calling thread assembles
    the next bucket (see the module docstring for the thread model).

    Same constructor as the base scheduler plus ``max_in_flight`` (>= 1;
    2 = double-buffering).  The dispatch worker starts lazily on the
    first :meth:`pump`/:meth:`drain` and must be released with
    :meth:`close` (or use the scheduler as a context manager); a
    :meth:`drain` returns with the worker still running, ready for the
    next batch of submissions.
    """

    def __init__(self, queue=None, *, max_in_flight: int = 2, **kwargs):
        if max_in_flight < 1:
            raise ValueError(
                f"max_in_flight must be >= 1, got {max_in_flight}")
        super().__init__(queue, **kwargs)
        self.max_in_flight = max_in_flight
        self._retry_lock = threading.Lock()
        self._flight = threading.Condition()
        self._inflight: deque[_InFlight] = deque()
        self._stopping = False
        self._worker_error: BaseException | None = None
        self._thread: threading.Thread | None = None

    # -- retry/bisect state: base-class policy under the retry lock --------

    def _backoff_snapshot(self) -> dict:
        with self._retry_lock:
            return super()._backoff_snapshot()

    def _bisect_limit(self, sig: tuple) -> int | None:
        with self._retry_lock:
            return super()._bisect_limit(sig)

    def _note_success(self, sig: tuple) -> None:
        with self._retry_lock:
            super()._note_success(sig)

    def _note_failure(self, sig: tuple, n_bucket: int) -> bool:
        with self._retry_lock:
            return super()._note_failure(sig, n_bucket)

    # -- worker lifecycle --------------------------------------------------

    def start(self) -> None:
        """Start the dispatch worker (idempotent; :meth:`pump` and
        :meth:`drain` call this lazily)."""
        if self._thread is not None and self._thread.is_alive():
            return
        with self._flight:
            self._stopping = False
        self._thread = threading.Thread(
            target=self._worker_loop, name="dgo-dispatch-worker",
            daemon=True)
        self._thread.start()

    def close(self, timeout_s: float | None = None) -> None:
        """Stop the dispatch worker after it finalizes every in-flight
        wave, and join it (``TimeoutError`` after ``timeout_s``).  Safe to
        call repeatedly; :meth:`start` (or the next pump/drain) revives
        the scheduler afterwards."""
        thread = self._thread
        if thread is None:
            return
        with self._flight:
            self._stopping = True
            self._flight.notify_all()
        thread.join(timeout_s)
        if thread.is_alive():
            raise TimeoutError("the dispatch worker did not stop in time")
        self._thread = None

    def __enter__(self) -> "PipelinedScheduler":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def in_flight(self) -> int:
        """Waves currently submitted but not yet finalized."""
        with self._flight:
            return len(self._inflight)

    def _raise_worker_error(self) -> None:
        with self._flight:
            err = self._worker_error
        if err is not None:
            raise RuntimeError(
                "pipelined dispatch worker crashed; in-flight handles "
                "were failed") from err

    # -- the pipelined serving loop ----------------------------------------

    def pump(self) -> bool:
        """Assemble and SUBMIT at most one wave, without blocking on any
        results.  Returns True when work happened — a wave was handed to
        the worker, or a submit-side dispatch failure was absorbed into
        retry bookkeeping.  False when the pipeline is at
        ``max_in_flight`` or nothing was poppable (queue empty / every
        bucket backed off)."""
        self.start()
        self._raise_worker_error()
        # depth is snapshotted HERE, where assembly begins: the overlap
        # the pipeline buys is host-side bucket work running while prior
        # waves run; sampled after submit_wave returns, the worker may
        # already have finalized the wave before.
        with self._flight:
            prior = len(self._inflight)
            if prior >= self.max_in_flight:
                return False
        popped = self._pop_wave()
        if popped is None:
            return False
        bucket, width, sig, wave = popped
        seqs = frozenset(h.seq for h in bucket)
        t0 = time.perf_counter()
        try:
            with spans.wave(wave), spans.span(
                    "serving.submit", start_ns=wave and wave.popped_ns):
                if self.faults is not None:
                    self.faults.before_dispatch(self._dispatches, seqs)
                if self.injector is not None:
                    self.injector.maybe_fail(self._dispatches)
                pending = submit_wave(
                    [h.request for h in bucket], mesh=self.mesh,
                    pop_axes=self.pop_axes,
                    virtual_block=self.virtual_block,
                    max_bits=self.max_bits, bits_step=self.bits_step,
                    pad_to=width, device=self.device)
        except Exception as err:            # noqa: BLE001 — submit-side
            # failures (fault plan, injector, bad input) are absorbed here
            # on the scheduler thread; fetch-side ones on the worker
            self.metrics_.record_failed_wave(time.perf_counter() - t0)
            self._register_failure(sig, bucket, err)
            return True
        with self._flight:
            self._inflight.append(_InFlight(bucket, width, sig,
                                            pending, t0, wave))
            self._flight.notify_all()
        self.metrics_.record_inflight(prior + 1)
        return True

    def step(self) -> bool:
        """The CLI loop primitive (non-blocking here): one :meth:`pump`."""
        return self.pump()

    def drain(self, timeout_s: float | None = None) -> int:
        """Serve until the queue is empty AND every in-flight wave has
        been finalized (retries included); returns the number of
        requests completed (``TimeoutError`` past ``timeout_s``).  The
        worker stays running for subsequent submissions — :meth:`close`
        releases it."""
        self.start()
        before = self.metrics_.completed
        end = None if timeout_s is None else time.perf_counter() + timeout_s
        while True:
            _check_deadline(end)
            if self.pump():
                continue
            with self._flight:
                if self._inflight:
                    # a finalize (or worker crash) notifies; the timeout
                    # only bounds the window before re-checking backoff
                    # releases armed by the worker
                    self._flight.wait(timeout=0.05)
                    continue
            self._raise_worker_error()
            # in-flight was empty above, so every failed wave's requeues
            # are already visible in the queue — no lost-work window
            if not len(self.queue):
                break
            wait = self.backoff_wait_s()
            if wait > 0:
                self.metrics_.record_backoff(wait)
                time.sleep(wait)
        return self.metrics_.completed - before

    # -- the dispatch worker -----------------------------------------------

    def _worker_loop(self) -> None:
        try:
            while True:
                with self._flight:
                    while not self._inflight and not self._stopping:
                        self._flight.wait()
                    if not self._inflight:
                        return          # stopping, everything finalized
                    # peek, don't pop: the wave stays visible in the
                    # depth accounting until its handles are terminal
                    flight = self._inflight[0]
                self._finalize(flight)
                with self._flight:
                    self._inflight.popleft()
                    self._flight.notify_all()
        except BaseException as err:        # noqa: BLE001 — safety net:
            # a bug past _finalize's own handler must not strand callers
            # blocked on handles or on drain(); fail everything loudly
            with self._flight:
                self._worker_error = err
                for flight in self._inflight:
                    for handle in flight.bucket:
                        wrapped = RuntimeError(
                            f"request {handle.seq} lost: dispatch "
                            f"worker crashed ({type(err).__name__})")
                        wrapped.__cause__ = err
                        handle._fail(wrapped)
                self._inflight.clear()
                self._flight.notify_all()

    def _finalize(self, flight: _InFlight) -> None:
        """Block on one wave's device results and run the base class's
        terminal bookkeeping (completion, retry/backoff/bisection)."""
        with spans.wave(flight.wave):
            try:
                flight.pending.wait()
                back_ns = spans.now() if flight.wave else None
                results = flight.pending.finalize()
            except Exception as err:        # noqa: BLE001 — the serving
                # loop survives any dispatch failure by requeueing it
                self.metrics_.record_failed_wave(
                    time.perf_counter() - flight.t0)
                self._register_failure(flight.sig, flight.bucket, err)
                return
            with spans.span("serving.finalize", start_ns=back_ns):
                # wave wall time spans submit -> results consumed;
                # overlapped waves overlap their busy_s, so wall-clock
                # throughput is the caller's (completed / wall), not
                # completed / busy_s
                elapsed = time.perf_counter() - flight.t0
                self._note_success(flight.sig)  # the bucket recovered
                self._complete_bucket(flight.bucket, results)
        self.metrics_.record_wave(len(flight.bucket), flight.width,
                                  elapsed)
        self._note_dispatch_time(elapsed)
