"""Milliseconds a wave spends in dispatch, submit to answers (the engine
layer): the scheduler's ``busy_s`` over its ``waves`` across the traced
span. Closed loops."""


def read(rec):
    c = rec["counters"]
    if c["waves"] <= 0:
        return None
    return 1e3 * c["busy_s"] / c["waves"]
