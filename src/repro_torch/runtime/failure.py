"""Failure injection: the Bernoulli step injector and the scripted fault
plan (a copy of ``repro.runtime.failure``: numpy and time only).

``FailureInjector`` deterministically raises ``SimulatedFailure`` at a
seeded rate.  For DGO it plugs into the *host-stepped* driver:
``Distributed(driver="host", injector=...)`` polls ``maybe_fail`` each
round and answers an injected failure by shrinking the quorum
(``runtime.elastic.drop_shard``) instead of restarting — the device
driver's loop cannot interpose host policy mid-run, which is why the host
path is kept.  The serving scheduler polls it once per dispatch.

``FaultPlan`` is the serving layer's fault model: a deterministic, seeded
plan of dispatch exceptions, per-request poison, latency spikes and
non-finite result corruption that ``serving.Scheduler`` polls around
every dispatch (scripted or probabilistic; ``launch/serve.py --dgo``'s
``--fault-rate`` builds one).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Collection

import numpy as np


class SimulatedFailure(RuntimeError):
    """Raised in place of a real node failure."""


class PoisonError(SimulatedFailure):
    """An injected per-request poison: any dispatch whose wave contains a
    poisoned request fails with this error (naming the poisoned sequence
    number), no matter how often it is retried — the serving scheduler's
    quarantine bisection must isolate it so it fails alone."""

    def __init__(self, seq: int):
        super().__init__(f"injected poison request (seq={seq})")
        self.seq = seq


class FailureInjector:
    def __init__(self, rate: float, seed: int = 0):
        self.rate = rate
        self.rng = np.random.default_rng(seed)
        self.injected = 0

    def maybe_fail(self, step: int) -> None:
        if self.rate > 0 and self.rng.random() < self.rate:
            self.injected += 1
            raise SimulatedFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class FaultPlan:
    """A deterministic, seeded fault plan for the serving dispatch loop.

    Every decision is a pure function of ``(seed, kind, index-or-seq)``
    — NOT of call order — so a retried dispatch re-rolls under its own
    dispatch index, two runs of one plan see identical faults, and a
    scripted test can predict exactly which dispatches fail.  Faults
    compose: one dispatch can spike AND fail.

    Probabilistic knobs (Bernoulli per dispatch / per request):

    * ``dispatch_error_rate`` — dispatch raises ``SimulatedFailure``;
    * ``latency_rate`` / ``latency_s`` — sleep before the dispatch
      (a straggling wave, visible in latency percentiles);
    * ``nonfinite_rate`` — per REQUEST (keyed by handle seq, so the
      corruption is persistent across retries like a genuinely NaN
      objective): the request's result is returned with non-finite
      ``best_f``/``trace``.

    Scripted knobs (exact indices, for chaos tests):

    * ``error_dispatches`` — dispatch indices that raise;
    * ``latency_dispatches`` — dispatch indices that spike;
    * ``poison_seqs`` — request sequence numbers that poison every wave
      containing them (``PoisonError``, fails on every retry);
    * ``nonfinite_seqs`` — request seqs whose results are corrupted.

    ``max_failures`` caps the *probabilistic* dispatch errors injected
    (scripted and poison faults are exempt) so a chaos run can be made to
    settle.  Counters (``injected_*``) report what actually fired.
    """

    seed: int = 0
    dispatch_error_rate: float = 0.0
    latency_rate: float = 0.0
    latency_s: float = 0.02
    nonfinite_rate: float = 0.0
    error_dispatches: Collection[int] = frozenset()
    latency_dispatches: Collection[int] = frozenset()
    poison_seqs: Collection[int] = frozenset()
    nonfinite_seqs: Collection[int] = frozenset()
    max_failures: int | None = None

    def __post_init__(self):
        self.error_dispatches = frozenset(self.error_dispatches)
        self.latency_dispatches = frozenset(self.latency_dispatches)
        self.poison_seqs = frozenset(self.poison_seqs)
        self.nonfinite_seqs = frozenset(self.nonfinite_seqs)
        self.injected_errors = 0
        self.injected_latency = 0
        self.injected_poison = 0
        self.injected_nonfinite = 0

    @property
    def injected(self) -> int:
        """Total faults fired (all kinds)."""
        return (self.injected_errors + self.injected_latency
                + self.injected_poison + self.injected_nonfinite)

    def _bernoulli(self, kind: int, index: int, rate: float) -> bool:
        if rate <= 0.0:
            return False
        return bool(
            np.random.default_rng((self.seed, kind, index)).random() < rate)

    def before_dispatch(self, index: int, seqs: Collection[int]) -> None:
        """Poll the plan for one dispatch (index = the scheduler's
        dispatch counter, seqs = the wave's handle sequence numbers):
        sleeps on a latency spike, raises on poison or an injected
        dispatch error."""
        if (index in self.latency_dispatches
                or self._bernoulli(0, index, self.latency_rate)):
            self.injected_latency += 1
            time.sleep(self.latency_s)
        for seq in sorted(self.poison_seqs):
            if seq in seqs:
                self.injected_poison += 1
                raise PoisonError(seq)
        if index in self.error_dispatches:
            self.injected_errors += 1
            raise SimulatedFailure(
                f"injected dispatch failure at dispatch {index}")
        if self._bernoulli(1, index, self.dispatch_error_rate):
            if (self.max_failures is None
                    or self.injected_errors < self.max_failures):
                self.injected_errors += 1
                raise SimulatedFailure(
                    f"injected dispatch failure at dispatch {index}")

    def corrupts_result(self, seq: int) -> bool:
        """Whether request ``seq``'s results come back non-finite under
        this plan (persistent across retries — keyed by seq alone)."""
        return (seq in self.nonfinite_seqs
                or self._bernoulli(2, seq, self.nonfinite_rate))

    def corrupt_results(self, seqs, results: list) -> list:
        """Replace the results of corrupted requests with non-finite
        copies (NaN ``best_f``, NaN ``trace``) — the injected analogue of
        an objective going NaN mid-solve.  Extras are preserved except
        ``finite``, which flips to False."""
        out = []
        for seq, res in zip(seqs, results):
            if self.corrupts_result(seq):
                self.injected_nonfinite += 1
                extras = dict(res.extras)
                extras["finite"] = False
                res = res._replace(
                    best_f=np.float32(np.nan),
                    trace=np.full_like(np.asarray(res.trace, np.float32),
                                       np.nan),
                    extras=extras)
            out.append(res)
        return out
