"""What the per-layer metric readers (``metrics/<name>.py``) share.

A reader takes a traced run's record: ``counters`` (the program's
counters, differences across the traced span), ``waves`` (each wave
answered in the span: its slots, its longest slot's steps, all its
slots' steps), ``trace`` (the profiler's numbers,
:func:`dgobench.trace.summarize`), ``config`` and ``count`` (the
configuration and its objective's count, ``counts/<problem>.py``),
``latencies_s`` (send to result of every request answered in the
window).  Each reader returns None where it finds nothing to read."""
from __future__ import annotations


def steps(rec) -> int:
    """DGO steps: over the waves, each wave's longest slot."""
    return sum(w[1] for w in rec["waves"])


def slot_steps(rec) -> int:
    """Restart-steps: every slot's steps, over the waves."""
    return sum(w[2] for w in rec["waves"])
