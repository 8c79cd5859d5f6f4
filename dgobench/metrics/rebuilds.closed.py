"""Builds inside the traced waves (the engine layer): the batched
engine built on a miss of its cache (``engine.build``) and a step's rows
bound for a CUDA stream or quorum not yet bound (``popstep.bind``), as
the program's spans count them (``repro_torch.core.spans``, looked up
among the loaded modules; None where there is no such module or it holds
no traced wave). The warm-up should leave none. Closed loops."""
import sys


def read(rec):
    spans = sys.modules.get("repro_torch.core.spans")
    if spans is None:
        return None
    s = spans.snapshot()["spans"]
    if "serving.submit" not in s:
        return None
    return sum(s[n]["count"] for n in ("engine.build", "popstep.bind")
               if n in s)
