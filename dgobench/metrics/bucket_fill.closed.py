"""Share of the waves' slots that carried a request (the serving layer's
fill): the scheduler's ``slots`` and ``padded_slots`` across the traced
span. Closed loops."""


def read(rec):
    c = rec["counters"]
    if c["slots"] <= 0:
        return None
    return 100.0 * (c["slots"] - c["padded_slots"]) / c["slots"]
