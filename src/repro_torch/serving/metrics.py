"""Serving observability: latency percentiles, wave/bucket counters, and
the engine-cache snapshot — one ``snapshot()`` dict the CLI prints and
tests assert on (a copy of ``repro.serving.metrics``).
"""
from __future__ import annotations

import dataclasses
from collections import deque

# latency percentiles are computed over a bounded window of the most
# recent completions — a long-lived scheduler must not grow (or sort)
# an unbounded history on every metrics poll
LATENCY_WINDOW = 4096


def percentile(values, q: float) -> float:
    """Linear-interpolated percentile (``q`` in [0, 100]) of a sequence.

    Tiny and dependency-free so the metrics path stays cheap (handles are
    completed on the dispatch thread).
    """
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of an empty sequence")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q must be in [0, 100], got {q}")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


@dataclasses.dataclass
class ServingMetrics:
    """Counters + latency samples for one scheduler's lifetime."""

    completed: int = 0
    failed: int = 0
    requeued: int = 0
    waves: int = 0
    warmup_waves: int = 0
    failed_waves: int = 0
    bisected_waves: int = 0   # quarantine probes of a split failed bucket
    nonfinite: int = 0        # results flagged non-finite (extras["finite"])
    slots: int = 0          # total wave slots dispatched (active + padded)
    padded_slots: int = 0   # inactive padding slots
    busy_s: float = 0.0     # wall seconds inside dispatches
    backoff_s: float = 0.0  # wall seconds slept waiting out retry backoff
    # pipeline depth accounting (record_inflight, one sample per wave
    # entering the dispatch stage): the synchronous scheduler always
    # records depth 1; the pipelined scheduler records how many waves
    # were in flight the moment it BEGAN assembling each bucket
    submitted_waves: int = 0   # successfully dispatched waves sampled
    overlapped_waves: int = 0  # submissions landing behind >= 1 in flight
    peak_in_flight: int = 0    # deepest observed in-flight depth

    def __post_init__(self):
        self._latencies: deque[float] = deque(maxlen=LATENCY_WINDOW)

    def record_wave(self, n_active: int, width: int, elapsed_s: float):
        self.waves += 1
        self.slots += width
        self.padded_slots += width - n_active
        self.busy_s += elapsed_s

    def record_failed_wave(self, elapsed_s: float):
        self.failed_waves += 1
        self.busy_s += elapsed_s

    def record_completion(self, latency_s: float):
        self.completed += 1
        self._latencies.append(latency_s)

    def record_requeue(self):
        self.requeued += 1

    def record_failure(self):
        self.failed += 1

    def record_warmup(self):
        self.warmup_waves += 1

    def record_bisect(self):
        self.bisected_waves += 1

    def record_nonfinite(self):
        self.nonfinite += 1

    def record_backoff(self, slept_s: float):
        self.backoff_s += slept_s

    def record_inflight(self, depth: int):
        """One wave entered the dispatch stage with ``depth`` waves (it
        included) in flight when its assembly began.  ``overlap_fraction``
        in the snapshot is the fraction of waves whose host-side assembly
        and submission ran while another wave was still on device — 0.0
        for the synchronous scheduler, approaching 1.0 when the pipeline
        keeps the device continuously busy."""
        self.submitted_waves += 1
        if depth > 1:
            self.overlapped_waves += 1
        if depth > self.peak_in_flight:
            self.peak_in_flight = depth

    def snapshot(self) -> dict:
        """Everything a serving endpoint reports: request/wave counters,
        bucket fill, latency percentiles and the engine-cache subsystem
        snapshot (``core.cache.snapshot()``).  Throughput is the
        caller's: completions over its own wall clock (``busy_s`` counts
        overlapping waves twice)."""
        from repro_torch.core import cache

        cache_snap = cache.snapshot()
        out = {
            "completed": self.completed,
            "failed": self.failed,
            "requeued": self.requeued,
            "waves": self.waves,
            "failed_waves": self.failed_waves,
            "bisected_waves": self.bisected_waves,
            "nonfinite_results": self.nonfinite,
            "warmup_waves": self.warmup_waves,
            "slots": self.slots,
            "padded_slots": self.padded_slots,
            "fill_fraction": ((self.slots - self.padded_slots) / self.slots
                              if self.slots else None),
            "busy_s": self.busy_s,
            "backoff_s": self.backoff_s,
            # pipeline health: how often submissions overlapped an
            # in-flight wave, and the deepest depth reached (1 == fully
            # synchronous; see record_inflight)
            "overlap_fraction": (self.overlapped_waves
                                 / self.submitted_waves
                                 if self.submitted_waves else None),
            "max_in_flight_depth": self.peak_in_flight,
            # percentiles over the LATENCY_WINDOW most recent completions
            "latency_p50_ms": None,
            "latency_p95_ms": None,
            "latency_p99_ms": None,
            "cache": cache_snap,
            # surfaced top-level: LRU churn here is the first sign a
            # workload's signature diversity outgrew the engine cache
            "cache_evictions": cache_snap["totals"]["evictions"],
        }
        # snapshot the deque first: a monitoring thread may poll while
        # the dispatch thread appends completions
        latencies = list(self._latencies)
        if latencies:
            out["latency_p50_ms"] = 1e3 * percentile(latencies, 50)
            out["latency_p95_ms"] = 1e3 * percentile(latencies, 95)
            out["latency_p99_ms"] = 1e3 * percentile(latencies, 99)
        return out
