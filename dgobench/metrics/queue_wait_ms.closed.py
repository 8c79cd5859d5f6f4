"""Milliseconds a request waits in the queue, its submit to the pop of
its wave (the serving layer): the mean of the program's
``serving.queue_wait`` spans.  The spans are the program's own
(``repro_torch.core.spans``, recorded for the waves a profiler session
saw assembled), looked up among the loaded modules: None where the
program has no such module or it holds no traced wave. Closed loops."""
import sys


def read(rec):
    spans = sys.modules.get("repro_torch.core.spans")
    if spans is None:
        return None
    s = spans.snapshot()["spans"].get("serving.queue_wait")
    if not s or s["count"] <= 0:
        return None
    return 1e3 * s["total_s"] / s["count"]
