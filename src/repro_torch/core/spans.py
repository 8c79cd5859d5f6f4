"""Spans and counters of the serving path, on the profiler's clock: the
serving and engine layers' own timing, kept process-wide beside
``core.cache``'s engine-cache counters and in its idiom (thread-safe,
:func:`snapshot`, :func:`clear`).

**The switch is the profiler.**  A wave is traced when a
``torch.profiler`` session records on the thread that assembles it
(:func:`profiling`, checked once a wave by ``Scheduler.run_wave`` and
``PipelinedScheduler.pump``).  The decision travels with the wave:
:func:`wave` marks each thread while it works on a traced wave (the
scheduler thread while it pops and submits, the wave's own thread, the
dispatch worker while it finalizes), and only a marked thread records.
Untraced, a wave costs that check and a few reads of a thread-local:
nothing a step or a request, nothing allocated, no device work and no
synchronisation either way.

**The clock** is ``time.time_ns()``, the clock of the profiler's events
(``start_ns()``, and ``baseTimeNanoseconds`` plus ``ts`` in its Chrome
trace), so the spans sit beside the device's activity.

**In memory**: per span name the count, total seconds and self seconds
(the duration less what its child spans cover), never dropped; the
counters; and the raw spans in a buffer of ``RAW_SPANS`` (``dropped``
counts what fell out of it).  :func:`export_chrome` writes the raw spans
as Chrome-trace events.

The spans and counters, by thread:

- scheduler thread: ``serving.queue_wait`` (a request's submit to the
  pop of its wave; carries the request id), ``serving.submit`` (the pop
  to ``submit_wave`` returned), its children ``engine.starts`` (the
  starts snapped and evaluated row by row) and ``engine.build`` (a miss
  of the batched engine's cache);
- the wave's thread: ``engine.loop`` (its loop, to results on the host),
  its children ``engine.stall_read`` (each host read of the live flag),
  ``engine.fetch`` (the results' copy to the host) and ``popstep.bind``
  (a step's rows bound for a CUDA stream or quorum not yet bound);
  counters ``engine.steps`` (loop iterations) and ``engine.slot_steps``
  (the live slots' steps);
- dispatch worker: ``serving.finalize`` (the wave's results back on the
  worker to its last handle completed).

Every span carries its wave's id (the scheduler's dispatch index), its
thread and its parent span.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

RAW_SPANS = 1 << 16
FIELDS = ("name", "start_ns", "end_ns", "thread", "thread_name", "wave",
          "request", "id", "parent")
# Chrome-trace tracks of the request spans (queue waits), past any
# thread id: one lane holds waves whose waits do not overlap
_LANE_TID = 1 << 30


class Wave(NamedTuple):
    """A traced wave: the scheduler's dispatch index, and when the pop
    of its bucket began."""

    id: int
    popped_ns: int


class _Recorder:
    def __init__(self, capacity: int):
        self.lock = threading.Lock()
        self.raw: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.totals: dict[str, list[int]] = {}  # count, total_ns, self_ns
        self.counters: dict[str, int] = {}

    def add(self, rec: tuple, self_ns: int) -> None:
        with self.lock:
            if len(self.raw) == self.raw.maxlen:
                self.dropped += 1
            self.raw.append(rec)
            t = self.totals.setdefault(rec[0], [0, 0, 0])
            t[0] += 1
            t[1] += rec[2] - rec[1]
            t[2] += self_ns

    def clear(self) -> None:
        with self.lock:
            self.raw.clear()
            self.dropped = 0
            self.totals.clear()
            self.counters.clear()


_RECORDER = _Recorder(RAW_SPANS)
_LOCAL = threading.local()
_IDS = itertools.count(1)
_NULL = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a profiler session records on this thread: the switch."""
    return torch.autograd._profiler_enabled()


def now() -> int:
    """The profiler's clock, in nanoseconds."""
    return time.time_ns()


def from_perf(t: float) -> int:
    """A ``time.perf_counter()`` reading on the profiler's clock."""
    return time.time_ns() - round((time.perf_counter() - t) * 1e9)


def current_wave() -> Wave | None:
    """The traced wave this thread works on, or None."""
    return getattr(_LOCAL, "wave", None)


def traced() -> bool:
    """Whether this thread works on a traced wave."""
    return getattr(_LOCAL, "wave", None) is not None


class _Scope:
    __slots__ = ("_wave", "_prev")

    def __init__(self, wave_: Wave | None):
        self._wave = wave_

    def __enter__(self):
        self._prev = current_wave()
        _LOCAL.wave = self._wave

    def __exit__(self, *exc):
        _LOCAL.wave = self._prev


def wave(wave_: Wave | None):
    """Mark this thread as working on ``wave_`` (None: an untraced one)
    for the ``with`` block."""
    if wave_ is None and current_wave() is None:
        return _NULL
    return _Scope(wave_)


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _add(name: str, start: int, end: int, wave_: Wave, request, sid: int,
         parent, covered: int) -> None:
    if parent is not None:
        parent.covered += end - start
    th = threading.current_thread()
    _RECORDER.add((name, start, end, th.native_id, th.name, wave_.id,
                   request, sid, None if parent is None else parent.sid),
                  end - start - covered)


class _Span:
    __slots__ = ("name", "wave", "request", "start", "sid", "parent",
                 "covered")

    def __init__(self, name: str, wave_: Wave, request, start_ns):
        self.name, self.wave, self.request = name, wave_, request
        self.start = start_ns
        self.covered = 0

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.sid = next(_IDS)
        if self.start is None:
            self.start = time.time_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        _add(self.name, self.start, end, self.wave, self.request, self.sid,
             self.parent, self.covered)


def span(name: str, *, request: int | None = None,
         start_ns: int | None = None):
    """A span around the ``with`` block, child of the span open on this
    thread; from ``start_ns`` where given.  A no-op unless this thread
    works on a traced wave."""
    wave_ = current_wave()
    if wave_ is None:
        return _NULL
    return _Span(name, wave_, request, start_ns)


def record(name: str, start_ns: int, end_ns: int, *,
           request: int | None = None) -> None:
    """A span that has ended, timed elsewhere, as a child of the span
    open on this thread.  A no-op unless this thread works on a traced
    wave."""
    wave_ = current_wave()
    if wave_ is None:
        return
    stack = _stack()
    _add(name, start_ns, end_ns, wave_, request, next(_IDS),
         stack[-1] if stack else None, 0)


def count(name: str, n: int) -> None:
    """Add ``n`` to a counter, where this thread works on a traced
    wave."""
    if current_wave() is None:
        return
    with _RECORDER.lock:
        _RECORDER.counters[name] = _RECORDER.counters.get(name, 0) + int(n)


def snapshot() -> dict:
    """Everything recorded: ``spans`` (per name: ``count``, ``total_s``,
    ``self_s``), ``counters``, ``records`` (the raw spans held, each a
    dict of ``FIELDS``) and ``dropped``."""
    r = _RECORDER
    with r.lock:
        totals = {k: tuple(v) for k, v in r.totals.items()}
        counters, raw, dropped = dict(r.counters), list(r.raw), r.dropped
    return {
        "spans": {k: {"count": c, "total_s": t / 1e9, "self_s": s / 1e9}
                  for k, (c, t, s) in sorted(totals.items())},
        "counters": counters,
        "records": [dict(zip(FIELDS, rec)) for rec in raw],
        "dropped": dropped,
    }


def clear() -> None:
    """Drop every span and counter."""
    _RECORDER.clear()


def export_chrome(path) -> int:
    """Write the raw spans to ``path`` as Chrome-trace complete (``X``)
    events on the profiler's clock: a thread's spans on that thread's
    track (its native id, as the profiler's own tracks), a wave's queue
    waits, which overlap the next waves', on lanes of their own.  Where
    ``path`` holds a Chrome trace already (``prof.export_chrome_trace``'s),
    the spans join its events on its time base, so one file shows the
    program's spans beside the card's idle gaps.  Returns the number of
    spans written."""
    path = Path(path)
    trace = (json.loads(path.read_text()) if path.is_file()
             else {"traceEvents": []})
    base = int(trace.setdefault("baseTimeNanoseconds", 0))
    events = trace.setdefault("traceEvents", [])
    named = {(e.get("pid"), e.get("tid")) for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    pid = os.getpid()
    recs = snapshot()["records"]
    tracks: dict[int, str] = {}
    lane_of: dict[int, int] = {}     # wave -> lane of its queue waits
    lane_end: list[int] = []
    waits = collections.defaultdict(list)
    for r in recs:
        if r["request"] is not None:
            waits[r["wave"]].append(r)
    for w, rs in sorted(waits.items(),
                        key=lambda kv: min(r["start_ns"] for r in kv[1])):
        lo, hi = min(r["start_ns"] for r in rs), max(r["end_ns"] for r in rs)
        lane = next((i for i, e in enumerate(lane_end) if e <= lo),
                    len(lane_end))
        lane_end[lane:lane + 1] = [hi]
        lane_of[w] = lane
    for r in recs:
        if r["request"] is None:
            tid = r["thread"]
            tracks.setdefault(tid, r["thread_name"])
        else:
            tid = _LANE_TID + lane_of[r["wave"]]
            tracks.setdefault(tid, f"queue waits {lane_of[r['wave']]}")
        events.append({"ph": "X", "cat": "repro_torch.spans",
                       "name": r["name"], "pid": pid, "tid": tid,
                       "ts": (r["start_ns"] - base) / 1e3,
                       "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
                       "args": {k: r[k] for k in ("wave", "request", "id",
                                                  "parent")}})
    for tid, name in tracks.items():
        if (pid, tid) not in named:
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": name}})
    path.write_text(json.dumps(trace))
    return len(recs)
