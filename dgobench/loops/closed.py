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
"""
from __future__ import annotations

import collections
import dataclasses
import time

from dgobench.driver import DRAIN_S, Sent
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

    def _send(self, starts: Starts) -> Sent:
        from repro_torch.core.solver import SolveRequest

        levels, x0 = starts.next()
        return Sent(levels, self.sched.submit(SolveRequest(
            self.problem, x0=x0, max_iters=self.budget)))

    def warm_up(self, starts: Starts) -> list[Sent]:
        """``warmup_waves`` full waves, as the window sends them."""
        return self.run(starts, total=self.mix.warmup_requests)

    def run(self, starts: Starts, *, until: float | None = None,
            total: int | None = None, drain_s: float = DRAIN_S
            ) -> list[Sent]:
        """Keep every client's request outstanding, sending the next one
        when its result returns, until the clock passes ``until`` (or
        ``total`` requests were sent); then wait up to ``drain_s`` for
        the answers still out.  Returns every request sent, in order.

        The clients block on their results: between waves this thread
        sleeps on the oldest wave's last request, so it takes the
        interpreter from the program's threads only to send."""
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
        deadline = None
        while out:
            # a wave goes out whenever one in flight has returned
            while (self.sched.in_flight < self.mix.max_in_flight
                   and len(self.sched.queue)):
                if not self.sched.pump():
                    time.sleep(0.0002)
            if deadline is None and not more():
                deadline = time.perf_counter() + drain_s
            # waves return in the order they were sent and leave full, so
            # the oldest wave is the oldest ``wave_size`` requests out
            last = out[min(self.mix.wave_size, len(out)) - 1].handle
            wait = drain_s if deadline is None else max(
                deadline - time.perf_counter(), 0.0)
            try:
                last.result(timeout=wait)
            except TimeoutError:
                if deadline is not None and time.perf_counter() >= deadline:
                    break
            except Exception:     # noqa: BLE001 — a failed request is
                pass              # counted from its handle afterwards
            # the scheduler retires a wave just after its last answer
            retire = time.perf_counter() + 1.0
            while (self.sched.in_flight >= self.mix.max_in_flight
                   and time.perf_counter() < retire):
                time.sleep(0.0002)
            # a wave's clients send again together, or not at all, so
            # waves leave full up to the window's close
            again = more()
            while out and out[0].handle.done():
                out.popleft()
                if again:
                    send()
        return sent

    def close(self) -> None:
        self.sched.close(timeout_s=DRAIN_S)
