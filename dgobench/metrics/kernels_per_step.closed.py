"""Device kernels the trace recorded for each DGO step (the engine layer's
launches); a step is one of a wave's longest slot's. Closed loops."""
from dgobench import layers


def read(rec):
    t, n = rec["trace"], layers.steps(rec)
    if not t or not t["kernels"] or n <= 0:
        return None
    return t["kernels"] / n
