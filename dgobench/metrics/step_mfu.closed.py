"""The whole step's share of the float32 peak: the objective's needed
operations for every restart-step of the traced span
(``counts/<problem>.py``) at ``counts/peaks.py``'s peak, over the span's
wall. Closed loops."""
from dgobench import layers
from dgobench.counts import peaks


def read(rec):
    t, n = rec["trace"], layers.slot_steps(rec)
    if not t or n <= 0:
        return None
    ops = n * rec["count"].ops_per_restart_step(rec["config"])
    return 100.0 * ops / peaks.FP32_FLOPS / t["window_s"]
