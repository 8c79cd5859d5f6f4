"""The closed loop: ``clients`` callers, each with one request
outstanding, which it sends again when the result returns (callers that
wait for a reply, such as a tuning controller's workers).

A mix of this kind (``"kind": "closed"`` in ``traffic/<name>.json``)
gives ``clients``, ``wave_size`` (the scheduler's wave width),
``max_in_flight`` (waves on the card at once) and ``warmup_waves`` (full
waves run before the window, from start points of their own).  With
``clients`` a multiple of ``wave_size`` every wave leaves full.  Every
request carries the configuration's fixed budget, so the seed changes no
count, no size and no arrival: only the start points.

Two threads, as ``serve --dgo`` has them: the calling thread runs the
scheduler's own serving loop (``drain``), which submits a wave whenever
one in flight retires and otherwise waits on the scheduler's condition;
the callers are one thread that blocks on the oldest wave's last
request, sends that wave's callers' next requests, lets go of the
wave's rows its answers hold (:func:`~dgobench.driver.drop_rows`, no
call into torch) and blocks again.  Neither polls, so the harness takes
the interpreter from the program's threads (the wave threads and the
dispatch worker, which pace a host-bound cell) only to send.  The
answers are taken to the host once the window has closed
(:func:`~dgobench.driver.settle`).  ``wakeups`` counts the callers'
wake-ups, at most one a wave.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time

from dgobench.driver import DRAIN_S, Sent, drop_rows
from dgobench.traffic import Starts


@dataclasses.dataclass(frozen=True)
class Mix:
    clients: int
    wave_size: int
    max_in_flight: int
    warmup_waves: int

    @property
    def warmup_requests(self) -> int:
        return self.warmup_waves * self.wave_size


def parse(d: dict) -> Mix:
    """The mix of a traffic file of this kind."""
    mix = Mix(int(d["clients"]), int(d["wave_size"]),
              int(d["max_in_flight"]), int(d["warmup_waves"]))
    if min(mix.clients, mix.wave_size, mix.max_in_flight) < 1:
        raise ValueError(f"bad closed traffic mix {d}")
    return mix


class Loop:
    """A closed loop of ``mix.clients`` callers over one scheduler."""

    def __init__(self, problem, mix: Mix, budget: int, device):
        from repro_torch.serving import PipelinedScheduler

        self.problem, self.mix, self.budget = problem, mix, budget
        self.sched = PipelinedScheduler(
            wave_size=mix.wave_size, max_in_flight=mix.max_in_flight,
            device=device)
        self.wakeups = 0

    def _send(self, starts: Starts) -> Sent:
        from repro_torch.core.solver import SolveRequest

        levels, x0 = starts.next()
        handle = self.sched.submit(SolveRequest(
            self.problem, x0=x0, max_iters=self.budget))
        return Sent(levels, handle, handle.submitted_at)

    def warm_up(self, starts: Starts) -> list[Sent]:
        """``warmup_waves`` full waves, as the window sends them."""
        return self.run(starts, total=self.mix.warmup_requests)

    def run(self, starts: Starts, *, until: float | None = None,
            total: int | None = None, drain_s: float = DRAIN_S
            ) -> list[Sent]:
        """Keep every client's request outstanding, sending the next one
        when its result returns, until the clock passes ``until`` (or
        ``total`` requests were sent); then wait up to ``drain_s`` for
        the answers still out.  Returns every request sent, in order."""
        sent: list[Sent] = []
        out: collections.deque[Sent] = collections.deque()

        def more() -> bool:
            if total is not None:
                return len(sent) < total
            return time.perf_counter() < until

        def send() -> None:
            s = self._send(starts)
            sent.append(s)
            out.append(s)

        for _ in range(self.mix.clients):
            if more():
                send()
        deadline = None if until is None else until + drain_s
        failure: list[BaseException] = []

        def callers() -> None:
            try:
                self._callers(out, more, send, deadline, drain_s)
            except BaseException as err:    # noqa: BLE001 — re-raised
                failure.append(err)         # on the calling thread

        thread = threading.Thread(target=callers, name="dgobench-callers",
                                  daemon=True)
        thread.start()
        try:
            while thread.is_alive():
                left = (None if deadline is None
                        else deadline - time.perf_counter())
                if left is not None and left <= 0:
                    break
                try:
                    self.sched.drain(timeout_s=left)
                except TimeoutError:
                    break
                # the queue ran empty between a wave's return and its
                # callers' next requests: serve again once they are in
                thread.join(0.01)
        finally:
            thread.join(drain_s)
        if failure:
            raise failure[0]
        return sent

    def _callers(self, out, more, send, deadline, drain_s) -> None:
        """The callers' thread: wait for the oldest wave, send its
        callers' next requests together (or none, once the window has
        closed, so waves leave full up to the close), let go of its
        rows."""
        while out:
            # waves return in the order they were sent and leave full, so
            # the oldest wave is the oldest ``wave_size`` requests out,
            # and its last request is answered last
            last = out[min(self.mix.wave_size, len(out)) - 1].handle
            wait = drain_s if deadline is None else max(
                deadline - time.perf_counter(), 0.0)
            try:
                last.result(timeout=wait)
            except TimeoutError:
                return
            except Exception:     # noqa: BLE001 — a failed request is
                pass              # counted from its handle afterwards
            self.wakeups += 1
            again = more()
            returned = []
            while out and out[0].handle.done():
                returned.append(out.popleft())
                if again:
                    send()
            drop_rows(returned)

    def close(self) -> None:
        self.sched.close(timeout_s=DRAIN_S)
