"""Optimization serving on the card: queue -> signature buckets -> the
batched engine (``repro.serving``, ported).

Callers submit heterogeneous :class:`~repro_torch.core.solver.
SolveRequest` s to a :class:`RequestQueue` and get future-like
:class:`RequestHandle` s back; a :class:`Scheduler` pulls
same-engine-signature buckets off the queue (continuous batching keyed by
:func:`~repro_torch.core.solver.engine_signature`), pads each bucket to
its wave width with inactive slots, and serves it through
:func:`~repro_torch.core.solver.solve_many` — one wave of the batched
engine, one popstep launch a step on the card, per-request results
bitwise identical to individual solves.

Quickstart::

    from repro_torch.core.solver import SolveRequest
    from repro_torch.serving import Scheduler

    sched = Scheduler(wave_size=8)                  # device=None: the card
    handles = [sched.submit(SolveRequest("rastrigin", seed=i,
                                         max_iters=64))
               for i in range(20)]
    sched.drain()
    best = [h.result().best_f for h in handles]
    print(sched.metrics())          # p50/p95 latency, fill, cache stats

The fault-tolerance contract is the reference's: a bounded queue with an
admission policy (``reject`` / ``shed-lowest-priority`` / ``block``,
:class:`QueueFull`), per-request deadlines (:class:`DeadlineExceeded`),
failed dispatches requeued with retry accounting, exponential backoff
and quarantine bisection (a ``runtime.failure.FaultPlan`` or
``FailureInjector`` scripts them), :class:`DispatchFailed` per exhausted
handle, and non-finite results flagged or failed.
:class:`PipelinedScheduler` keeps up to ``max_in_flight`` waves running
while the calling thread assembles the next; ``launch/serve.py --dgo`` is
the CLI over this package.
"""
from repro_torch.serving.metrics import ServingMetrics, percentile
from repro_torch.serving.pipeline import PipelinedScheduler
from repro_torch.serving.queue import (
    DeadlineExceeded,
    DispatchFailed,
    QueueFull,
    RequestHandle,
    RequestQueue,
)
from repro_torch.serving.scheduler import Scheduler, warmup

__all__ = [
    "DeadlineExceeded",
    "DispatchFailed",
    "PipelinedScheduler",
    "QueueFull",
    "RequestHandle",
    "RequestQueue",
    "Scheduler",
    "ServingMetrics",
    "percentile",
    "warmup",
]
