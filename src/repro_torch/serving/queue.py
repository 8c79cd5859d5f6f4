"""Request queue + future-like handles for the serving subsystem (a copy
of ``repro.serving.queue``).

The queue is priority-ordered (higher ``SolveRequest.priority`` first,
FIFO within a priority class) and engine-policy-free: it knows nothing
about engines or buckets.  The scheduler supplies the signature function
to :meth:`RequestQueue.pop_bucket`, which implements the
continuous-batching pop — take up to ``limit`` queued requests sharing
one engine signature, skipping (and keeping) everything else.

Lifecycle robustness lives HERE, at the queue boundary:

* **capacity + admission** — a bounded queue refuses to backlog without
  bound under overload; ``admission`` picks how: ``"reject"`` raises
  :class:`QueueFull` at submit, ``"shed-lowest-priority"`` evicts the
  lowest-priority queued request (failing ITS handle with QueueFull) to
  admit a higher-priority arrival, ``"block"`` applies backpressure by
  blocking the submitter until a slot frees (or ``block_timeout_s``
  elapses);
* **deadlines** — ``SolveRequest.deadline_s`` is a TTL stamped onto the
  handle at submit; expired handles are failed with
  :class:`DeadlineExceeded` the moment any pop or admission sweep sees
  them, so they fail fast instead of occupying wave slots, and no pop
  ever returns an expired handle (no wave is dispatched containing one).
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Collection

from repro_torch.core.solver import SolveRequest, SolveResult

ADMISSION_POLICIES = ("reject", "shed-lowest-priority", "block")


class QueueFull(RuntimeError):
    """Admission control refused a request: the queue is at capacity and
    the policy could not (or chose not to) make room."""


class DeadlineExceeded(TimeoutError):
    """A request's TTL elapsed before it completed — failed fast instead
    of occupying a wave slot."""


class DispatchFailed(RuntimeError):
    """A request exhausted its dispatch retries.  Each exhausted handle
    gets its OWN instance (chained from the shared dispatch error via
    ``__cause__``), so re-raising from multiple handles never mutates one
    shared traceback."""

    def __init__(self, seq: int, retries: int, cause: BaseException):
        super().__init__(
            f"request {seq} failed after {retries} dispatch "
            f"failure(s): {type(cause).__name__}: {cause}")
        self.seq = seq


class RequestHandle:
    """Future-like handle for one submitted request.

    ``result()`` blocks until the scheduler completes or permanently
    fails the request (re-raising the failure), so producers on other
    threads can submit-and-wait.  ``retries`` counts CHARGED dispatch
    failures (see ``Scheduler._requeue_failed`` — quarantine bisection
    re-probes a split bucket without charging its members); ``requeues``
    counts every trip back onto the queue.  ``deadline_at`` is the
    absolute expiry stamped at submit from ``SolveRequest.deadline_s``
    (None = no deadline); an expired handle fails with
    :class:`DeadlineExceeded` at the next pop — or inside ``result()``,
    whose wait never outlives the deadline.
    """

    _UNSET = object()

    def __init__(self, request: SolveRequest, seq: int):
        self.request = request
        self.seq = seq
        self.submitted_at = time.perf_counter()
        self.completed_at: float | None = None
        self.deadline_at: float | None = (
            None if request.deadline_s is None
            else self.submitted_at + request.deadline_s)
        self.retries = 0
        self.requeues = 0
        self.error: BaseException | None = None
        self._result = self._UNSET
        self._event = threading.Event()
        self._terminal_lock = threading.Lock()
        # signature memo, stamped per-scheduler: the cached value is only
        # valid for the scheduler (token) whose dispatch geometry computed
        # it — a handle requeued into (or shared with) a scheduler with a
        # different mesh/schedule recomputes instead of bucketing under
        # the stale key
        self._signature = None
        self._signature_token = self._UNSET

    def done(self) -> bool:
        return self._event.is_set()

    def expired(self, now: float | None = None) -> bool:
        """Whether the deadline has passed (False when there is none)."""
        if self.deadline_at is None:
            return False
        return (time.perf_counter() if now is None else now) \
            >= self.deadline_at

    @property
    def signature(self):
        """The last stamped engine signature (None before any pop)."""
        return self._signature

    def signature_for(self, key: Callable, token: object):
        """The engine signature of this request under ``key``, memoized
        per ``token`` (the scheduler doing the popping)."""
        if self._signature_token is not token:
            self._signature = key(self.request)
            self._signature_token = token
        return self._signature

    def result(self, timeout: float | None = None) -> SolveResult:
        """The request's SolveResult; blocks until available.  Raises the
        dispatch error if the request permanently failed,
        :class:`DeadlineExceeded` once the request's deadline passes
        without completion, TimeoutError if ``timeout`` elapses first."""
        deadline_wait = None
        if self.deadline_at is not None:
            deadline_wait = max(self.deadline_at - time.perf_counter(), 0.0)
        wait = (deadline_wait if timeout is None
                else timeout if deadline_wait is None
                else min(timeout, deadline_wait))
        if not self._event.wait(wait):
            if self.expired():
                self._fail(DeadlineExceeded(
                    f"request {self.seq} missed its deadline "
                    f"({self.request.deadline_s}s after submit)"))
            else:
                raise TimeoutError(f"request {self.seq} not done")
        # the event is set, but take the terminal lock anyway: a _fail
        # racing a _complete publishes error/result/completed_at as one
        # atomic terminal state, and readers must observe it that way
        with self._terminal_lock:
            if self.error is not None:
                raise self.error
            return self._result

    @property
    def latency_s(self) -> float | None:
        """Submit-to-completion wall seconds (None while in flight)."""
        with self._terminal_lock:
            if self.completed_at is None:
                return None
            return self.completed_at - self.submitted_at

    def _complete(self, result: SolveResult) -> None:
        # first terminal state wins: a completion racing a deadline/shed
        # failure (or vice versa) must not overwrite it
        with self._terminal_lock:
            if self._event.is_set():
                return
            self._result = result
            self.completed_at = time.perf_counter()
            self._event.set()

    def _fail(self, error: BaseException) -> None:
        with self._terminal_lock:
            if self._event.is_set():
                return
            self.error = error
            self.completed_at = time.perf_counter()
            self._event.set()

    def __repr__(self):
        # intentionally racy snapshot: repr must never block on (or
        # deadlock with) a terminal transition in flight
        state = ("failed" if self.error is not None
                 else "done" if self.done() else "pending")
        name = getattr(self.request.problem, "name", self.request.problem)
        return (f"RequestHandle(seq={self.seq}, problem={name!r}, "
                f"{state}, retries={self.retries})")


class RequestQueue:
    """Thread-safe priority queue of :class:`RequestHandle`s with
    optional capacity bound + admission policy and deadline expiry (see
    module docstring).  Counters: ``rejected`` (QueueFull raised at
    submit), ``shed`` (queued handles evicted by shed-lowest-priority),
    ``expired`` (handles failed on deadline by the queue)."""

    def __init__(self, capacity: int | None = None,
                 admission: str = "reject",
                 block_timeout_s: float | None = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission must be one of "
                             f"{ADMISSION_POLICIES}, got {admission!r}")
        self.capacity = capacity
        self.admission = admission
        self.block_timeout_s = block_timeout_s
        self.rejected = 0
        self.shed = 0
        self.expired = 0
        self._heap: list[tuple[int, int, RequestHandle]] = []
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)
        self._seq = itertools.count()

    def submit(self, request, **kwargs) -> RequestHandle:
        """Enqueue a request; returns its handle.

        ``request`` is a :class:`SolveRequest` or anything its
        ``problem`` field accepts (a Problem / Objective / registry name
        — ``kwargs`` then become the remaining SolveRequest fields).
        The problem is coerced and validated HERE, at the submission
        boundary, not deep inside a dispatch.  Raises :class:`QueueFull`
        when admission control refuses the request (the returned-nothing
        contract: a raising submit never enqueues)."""
        if not isinstance(request, SolveRequest):
            request = SolveRequest(problem=request, **kwargs)
        elif kwargs:
            raise TypeError("kwargs only apply when submitting a bare "
                            "problem, not a SolveRequest")
        handle = RequestHandle(request.resolve(), next(self._seq))
        with self._space:
            self._admit_locked(handle)
            heapq.heappush(self._heap,
                           (-request.priority, handle.seq, handle))
        return handle

    def _admit_locked(self, handle: RequestHandle) -> None:
        """Make room for ``handle`` under the admission policy (or raise
        QueueFull).  Expired entries are purged first — dead requests
        must not hold capacity against live arrivals."""
        if self.capacity is None:
            return
        if len(self._heap) >= self.capacity:
            self._purge_expired_locked()
        if len(self._heap) < self.capacity:
            return
        if self.admission == "block":
            ok = self._space.wait_for(
                lambda: len(self._heap) < self.capacity,
                timeout=self.block_timeout_s)
            if not ok:
                self.rejected += 1
                err = QueueFull(
                    f"queue full (capacity {self.capacity}) and no slot "
                    f"freed within {self.block_timeout_s}s")
                handle._fail(err)
                raise err
            return
        if self.admission == "shed-lowest-priority":
            # victim = lowest priority, youngest within it (max heap key:
            # entries sort (-priority, seq), so the victim is max())
            victim_entry = max(self._heap)
            victim = victim_entry[2]
            if -victim_entry[0] >= handle.request.priority:
                # nothing queued is lower-priority than the arrival: the
                # arrival itself is the shed victim
                self.rejected += 1
                err = QueueFull(
                    f"queue full (capacity {self.capacity}); request "
                    f"priority {handle.request.priority} does not beat "
                    f"the lowest queued priority {-victim_entry[0]}")
                handle._fail(err)
                raise err
            self._heap.remove(victim_entry)
            heapq.heapify(self._heap)
            self.shed += 1
            victim._fail(QueueFull(
                f"request {victim.seq} shed (priority "
                f"{victim.request.priority}) for a priority "
                f"{handle.request.priority} arrival at capacity "
                f"{self.capacity}"))
            return
        self.rejected += 1
        err = QueueFull(f"queue full (capacity {self.capacity})")
        handle._fail(err)
        raise err

    def _purge_expired_locked(self, now: float | None = None) -> int:
        if now is None:
            now = time.perf_counter()
        dead = [e for e in self._heap if e[2].expired(now)]
        if not dead:
            return 0
        for entry in dead:
            self._heap.remove(entry)
            self._fail_expired_locked(entry[2])
        heapq.heapify(self._heap)
        self._space.notify_all()
        return len(dead)

    def _fail_expired_locked(self, handle: RequestHandle) -> None:
        self.expired += 1
        handle._fail(DeadlineExceeded(
            f"request {handle.seq} missed its deadline "
            f"({handle.request.deadline_s}s after submit)"))

    def requeue(self, handle: RequestHandle) -> None:
        """Put a handle back after a failed dispatch.  The original
        sequence number is kept, so a retried request resumes its place
        within its priority class instead of going to the back.  Retries
        bypass admission control — the handle already held a queue slot,
        so readmitting it cannot grow the backlog."""
        handle.requeues += 1
        with self._lock:
            heapq.heappush(self._heap,
                           (-handle.request.priority, handle.seq, handle))

    def pop_bucket(self, limit: int,
                   key: Callable[[SolveRequest], object] | None = None,
                   token: object = None,
                   exclude: Collection = (),
                   ) -> list[RequestHandle]:
        """Pop up to ``limit`` handles sharing ONE engine signature
        (continuous batching).  ``key`` maps a SolveRequest to its
        signature, memoized on the handle per ``token`` (the popping
        scheduler — see :meth:`RequestHandle.signature_for`); ``key=None``
        ignores signatures and pops strictly by priority order.  Handles
        with other signatures are left queued, order preserved.

        Expired handles are failed with :class:`DeadlineExceeded` and
        never returned — a popped bucket contains no dead requests.

        Bucket choice is deadline-aware ahead of front-of-queue greedy:
        when any queued request carries a deadline, the bucket is the
        signature of the most urgent live request (earliest deadline);
        otherwise the front (highest-priority) request's.  Signatures in
        ``exclude`` (e.g. buckets in retry backoff) are skipped entirely.
        """
        if limit < 1:
            raise ValueError(f"limit must be >= 1, got {limit}")
        exclude = set(exclude)
        now = time.perf_counter()
        picked: list[RequestHandle] = []
        with self._space:
            self._purge_expired_locked(now)
            if not self._heap:
                return []
            entries = sorted(self._heap)       # priority desc, FIFO within
            sig_of = {}
            for entry in entries:
                handle = entry[2]
                sig_of[handle.seq] = (
                    handle.signature_for(key, token) if key is not None
                    else None)
            # the target bucket: earliest-deadline live request wins;
            # tie (and the no-deadlines case) falls back to queue order
            candidates = [e for e in entries
                          if sig_of[e[2].seq] not in exclude] \
                if exclude else entries
            if not candidates:
                return []
            deadline_order = sorted(
                (e for e in candidates if e[2].deadline_at is not None),
                key=lambda e: e[2].deadline_at)
            target = (deadline_order[0] if deadline_order
                      else candidates[0])
            sig = sig_of[target[2].seq]
            keep = []
            for entry in entries:
                handle = entry[2]
                if len(picked) < limit and sig_of[handle.seq] == sig:
                    picked.append(handle)
                else:
                    keep.append(entry)
            self._heap = keep
            heapq.heapify(self._heap)
            if picked:
                self._space.notify_all()
        return picked

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)
