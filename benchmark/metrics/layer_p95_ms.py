"""layer_p95_ms: the 95th percentile (nearest rank) of every claim's
latency in the window, from its batch's dispatch to the end of its host
check; a claim that failed counts with the time it took to fail."""

import math


def read(run):
    if run.kind != "layer_claims" or not run.requests:
        return None
    lat = sorted(r.end - r.start for r in run.requests)
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
