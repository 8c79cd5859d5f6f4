"""95th percentile of send-to-result latency over every request answered
in the traced window (the serving layer). In a closed loop the queue
never empties, so the tail follows the waves' phase and belongs here, not
among the end-to-end metrics."""
import numpy as np


def read(rec):
    lat = rec["latencies_s"]
    if not lat:
        return None
    return 1e3 * float(np.percentile(lat, 95))
