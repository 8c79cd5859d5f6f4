"""Milliseconds the scheduler thread spends on a wave from the pop of its
bucket to ``submit_wave`` returned (the serving layer: the pop, the
starts evaluated row by row, the wave thread's start): the mean of the
program's ``serving.submit`` spans (``repro_torch.core.spans``, looked up
among the loaded modules; None where there is no such module or it holds
no traced wave). Closed loops."""
import sys


def read(rec):
    spans = sys.modules.get("repro_torch.core.spans")
    if spans is None:
        return None
    s = spans.snapshot()["spans"].get("serving.submit")
    if not s or s["count"] <= 0:
        return None
    return 1e3 * s["total_s"] / s["count"]
