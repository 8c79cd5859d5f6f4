"""Share of the traced window with nothing running on the card (the
device). Closed loops."""


def read(rec):
    t = rec["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
