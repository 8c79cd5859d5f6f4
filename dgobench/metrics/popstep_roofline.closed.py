"""The popstep kernel's share of its roofline (the kernel layer): the
least time of the launches the trace recorded, each stepping the waves'
mean live restarts (``counts/<problem>.py`` at ``counts/peaks.py``'s
peaks), over the seconds in which a popstep kernel ran. Closed loops."""
from dgobench import layers
from dgobench.counts import peaks


def read(rec):
    t, n = rec["trace"], layers.steps(rec)
    if not t or not t["popstep_launches"] or t["popstep_s"] <= 0 or n <= 0:
        return None
    live = layers.slot_steps(rec) / n
    cfg, count = rec["config"], rec["count"]
    least = peaks.least_seconds(live * count.ops_per_restart_step(cfg),
                                count.bytes_per_launch(cfg, live))
    return 100.0 * t["popstep_launches"] * least / t["popstep_s"]
