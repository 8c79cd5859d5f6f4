"""Microseconds of host time the wave thread spends a DGO step (the
engine layer): the program's ``engine.loop`` seconds less its host reads
of the live flag (``engine.stall_read``) and of the results
(``engine.fetch``), over its loop iterations (``engine.steps``), summed
over the traced waves in the program's recorder
(``repro_torch.core.spans``, looked up among the loaded modules; None
where there is no such module or no traced step). Closed loops."""
import sys


def read(rec):
    spans = sys.modules.get("repro_torch.core.spans")
    if spans is None:
        return None
    snap = spans.snapshot()
    steps = snap["counters"].get("engine.steps", 0)
    s = snap["spans"]
    if steps <= 0 or "engine.loop" not in s:
        return None
    host_s = s["engine.loop"]["total_s"] - sum(
        s[n]["total_s"] for n in ("engine.stall_read", "engine.fetch")
        if n in s)
    return 1e6 * host_s / steps
