"""Milliseconds from a wave's loop ending on its thread (``engine.loop``)
to its last handle completed on the dispatch worker (the end of
``serving.finalize``), the wait for the worker included (the serving
layer): the mean over the traced waves that hold both spans in the
program's recorder (``repro_torch.core.spans``, looked up among the
loaded modules; None where there is no such module or no such wave).
Closed loops."""
import sys


def read(rec):
    spans = sys.modules.get("repro_torch.core.spans")
    if spans is None:
        return None
    loop_end, fin_end = {}, {}
    for r in spans.snapshot()["records"]:
        if r["name"] == "engine.loop":
            loop_end[r["wave"]] = r["end_ns"]
        elif r["name"] == "serving.finalize":
            fin_end[r["wave"]] = r["end_ns"]
    waves = loop_end.keys() & fin_end.keys()
    if not waves:
        return None
    return sum(fin_end[w] - loop_end[w] for w in waves) / len(waves) / 1e6
